"""Physics-parameter estimation: object image -> simulator material params.

A copy of robosimgs_tpu/artic/physics.py (the port imports nothing from
the JAX package; the material tables are its own copy, materials/). The
flow is the upstream RoboSimGS physics_estimation
(`Articulation/physics_estimation.py`): caption the object (BLIP-2's
role), shortlist candidate materials with an MLLM (coarse JSON,
rigid-vs-deformable decides MPM vs PBD), zero-shot pick the material
with an image-text scorer (CLIP's role), look up table priors, then
optionally refine with an MLLM regression within physical ranges. Every
model is a pluggable interface (artic/mllm.py). Output schemas are the
Genesis material constructor contracts: MPM = {density, youngs_modulus,
poisson_ratio}; PBD = {density, static_friction, kinetic_friction,
stretch_compliance}. Fixes (not reproduces) the upstream table-path bug
(`Physical/` vs `material/`) and its swapped-argument round trip.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from robosimgs_tpu_torch.artic.mllm import (Captioner, ImageTextScorer, MLLMClient,
                                      extract_json, with_retry)

_TABLE_DIR = os.path.join(os.path.dirname(__file__), "materials")

# The coarse material vocabulary contract (reference `gpt_utils.py:57-67`).
MATERIAL_VOCABULARY = ("gelatin", "rubber", "leather", "nylon", "elastic",
                       "wood", "plant fiber", "metal")


def load_material_table(method: str = "mpm", table_dir: str = _TABLE_DIR) -> Dict[str, Dict]:
    name = "material_table.json" if method == "mpm" else "material_table_pbd.json"
    with open(os.path.join(table_dir, name)) as fh:
        data = json.load(fh)
    return {m["name"]: m for m in data["materials"]}


@dataclasses.dataclass
class PhysicsEstimate:
    method: str                  # "mpm" | "pbd"
    material: str
    caption: str
    candidates: List[str]
    scores: Dict[str, float]
    params: Dict[str, float]
    refined: bool = False

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


class PhysicsEstimator:
    def __init__(self, captioner: Optional[Captioner] = None,
                 scorer: Optional[ImageTextScorer] = None,
                 mllm: Optional[MLLMClient] = None,
                 table_dir: str = _TABLE_DIR):
        self.captioner = captioner
        self.scorer = scorer
        self.mllm = mllm
        self.table_dir = table_dir

    # -- stages ------------------------------------------------------------

    def coarse_candidates(self, image: np.ndarray, caption: str) -> Dict:
        """MLLM shortlist: top-3 materials, each tagged rigid|deformable."""
        if self.mllm is None:
            return {"1": "rigid: wood", "2": "rigid: metal", "3": "deformable: rubber"}
        prompt = (
            f"An object is described as: '{caption}'. From this material "
            f"vocabulary: {', '.join(MATERIAL_VOCABULARY)} — list the 3 most "
            "likely materials of the main object, most likely first, each "
            "prefixed with 'rigid:' or 'deformable:'. Answer as JSON: "
            '{"1": "rigid: wood", "2": ..., "3": ...}.'
        )
        resp = with_retry(lambda seed: self.mllm.chat(prompt, [image], seed=seed),
                          tries=3, sleep_s=0.0)
        return extract_json(resp)

    @staticmethod
    def parse_candidates(coarse: Dict) -> List[str]:
        out = []
        for k in sorted(coarse):
            v = str(coarse[k])
            out.append(v.split(":", 1)[-1].strip().lower())
        return out

    def pick_material(self, image: np.ndarray, candidates: Sequence[str]) -> Dict[str, float]:
        if self.scorer is None:
            return {c: (1.0 if i == 0 else 0.0) for i, c in enumerate(candidates)}
        labels = [f"a photo of {c} material" for c in candidates]
        probs = self.scorer.score(image, labels)
        return {c: float(p) for c, p in zip(candidates, probs)}

    def refine(self, image: np.ndarray, caption: str, method: str,
               material: str, baseline: Dict[str, float]) -> Optional[Dict[str, float]]:
        if self.mllm is None:
            return None
        if method == "mpm":
            keys = ("density", "youngs_modulus", "poisson_ratio")
            ranges = ("density in kg/m^3 (100..20000), youngs_modulus in the "
                      "simulator scale (0.5..200), poisson_ratio (0..0.5)")
        else:
            keys = ("density", "static_friction", "kinetic_friction",
                    "stretch_compliance")
            ranges = ("density in kg/m^3 (50..3000), static_friction (0..2), "
                      "kinetic_friction (0..2), stretch_compliance (0..0.1)")
        prompt = (
            f"Object: '{caption}', material: {material}. Baseline simulator "
            f"parameters: {json.dumps(baseline)}. Refine them for this "
            f"specific object. Valid ranges: {ranges}. Answer as JSON with "
            f"exactly these keys: {list(keys)}."
        )
        try:
            resp = with_retry(lambda seed: self.mllm.chat(prompt, [image], seed=seed),
                              tries=3, sleep_s=0.0)
            d = extract_json(resp)
            return {k: float(d[k]) for k in keys}
        except Exception:
            return None

    # -- full flow ---------------------------------------------------------

    def estimate(self, image: np.ndarray,
                 out_path: Optional[str] = None) -> PhysicsEstimate:
        caption = (self.captioner.caption(image) if self.captioner
                   else "an object")
        coarse = self.coarse_candidates(image, caption)
        use_mpm = "rigid" in str(coarse.get("1", "")).lower()
        method = "mpm" if use_mpm else "pbd"
        candidates = self.parse_candidates(coarse)
        scores = self.pick_material(image, candidates)
        material = max(scores, key=scores.get)

        table = load_material_table(method, self.table_dir)
        row = table.get(material)
        if row is None:  # nearest vocabulary fallback
            row = next(iter(table.values()))
        if method == "mpm":
            baseline = {"density": row.get("density", 1000.0),
                        "youngs_modulus": row["youngsModulus"],
                        "poisson_ratio": row["poissonRatio"]}
        else:
            baseline = {"density": row.get("density", 1000.0),
                        "static_friction": row["static_friction"],
                        "kinetic_friction": row["kinetic_friction"],
                        "stretch_compliance": row["stretch_compliance"]}

        refined = self.refine(image, caption, method, material, baseline)
        est = PhysicsEstimate(
            method=method, material=material, caption=caption,
            candidates=list(candidates), scores=scores,
            params=refined or baseline, refined=refined is not None)
        if out_path:
            with open(out_path, "w") as fh:
                json.dump(est.to_json(), fh, indent=2)
        return est
