"""Articulation pipeline: two part meshes -> physics-ready URDF.

A port of robosimgs_tpu/artic/pipeline.py, the redesign of the upstream
RoboSimGS URDFGenerationPipeline
(`Articulation/urdf_generation/pipeline.py`): optional MLLM
recommendation of URDF parameters from marked renders (object type,
base/movable link, joint limits, dynamics, masses) with the same
defaults when absent (limits ±0.785 rad, effort 5, velocity 2, friction
0.5, damping 0.2); base/movable swap honored; hinge detection (its
pairwise distances on `device`); both meshes recentered so the hinge
sits at the origin; URDF + metadata artifacts matching the upstream
`openbox_output/urdf/{articulated_object.urdf, metadata.json}` — with
the upstream lower-limit mismatch fixed, not reproduced.

Also carries the upstream CLI's lid/body identification
heuristic (`articulation_inference.py`): keyword vote over part names.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from robosimgs_tpu_torch.artic.hinge import HingeDetector
from robosimgs_tpu_torch.artic.mllm import MLLMClient, extract_json, with_retry
from robosimgs_tpu_torch.artic.urdf_builder import URDFBuilder
from robosimgs_tpu_torch.utils.meshio import Mesh, save_mesh

MOVABLE_KEYWORDS = ("lid", "cover", "top", "door", "flap", "cap", "handle")
BASE_KEYWORDS = ("body", "base", "bottom", "frame", "container", "box")


def identify_lid_and_body(names: Dict[str, str]) -> Tuple[str, str]:
    """Keyword vote: returns (movable_key, base_key) among the two parts."""
    def score(name: str) -> int:
        n = name.lower()
        return (sum(k in n for k in MOVABLE_KEYWORDS)
                - sum(k in n for k in BASE_KEYWORDS))

    keys = list(names)
    if len(keys) != 2:
        raise ValueError(f"expected exactly 2 parts, got {keys}")
    s0, s1 = score(names[keys[0]]), score(names[keys[1]])
    return (keys[0], keys[1]) if s0 >= s1 else (keys[1], keys[0])


@dataclasses.dataclass
class URDFParams:
    object_type: str = "unknown"
    lower: float = -0.785
    upper: float = 0.785
    effort: float = 5.0
    velocity: float = 2.0
    friction: float = 0.5
    damping: float = 0.2
    base_mass: float = 0.5
    movable_mass: float = 0.2
    swap_base_movable: bool = False
    reasoning: str = ""
    from_mllm: bool = False


class ArticulationPipeline:
    def __init__(self, movable: Mesh, base: Mesh,
                 robot_name: str = "articulated_object",
                 mllm: Optional[MLLMClient] = None,
                 contact_margin: float = 0.01,
                 hinge_trim: int = 0,
                 device="cuda"):
        self.movable = movable
        self.base = base
        self.robot_name = robot_name
        self.mllm = mllm
        self.contact_margin = contact_margin
        # robust trimmed contact-PCA iterations for mask-driven splits
        # (HingeDetector trim); 0 = exact upstream semantics
        self.hinge_trim = hinge_trim
        self.device = device

    # -- MLLM parameter recommendation -----------------------------------

    def recommend_params(self, marked_views=None,
                         movable_name: str = "movable part",
                         base_name: str = "base part") -> URDFParams:
        if self.mllm is None:
            return URDFParams()
        prompt = (
            "You see an articulated object split into two parts: "
            f"'{movable_name}' and '{base_name}'. Recommend URDF parameters "
            "for a single revolute joint between them. Consider the object "
            "type and plausible motion range. Answer as JSON with keys: "
            '{"object_type": str, "base_link": "movable"|"base", '
            '"lower_rad": float, "upper_rad": float, "effort": float, '
            '"velocity": float, "friction": float, "damping": float, '
            '"base_mass_kg": float, "movable_mass_kg": float, '
            '"reasoning": str}.'
        )
        imgs = marked_views or []
        try:
            resp = with_retry(lambda seed: self.mllm.chat(prompt, imgs, seed=seed),
                              tries=3, sleep_s=0.0)
            d = extract_json(resp)
        except Exception:
            return URDFParams()
        return URDFParams(
            object_type=str(d.get("object_type", "unknown")),
            lower=float(d.get("lower_rad", -0.785)),
            upper=float(d.get("upper_rad", 0.785)),
            effort=float(d.get("effort", 5.0)),
            velocity=float(d.get("velocity", 2.0)),
            friction=float(d.get("friction", 0.5)),
            damping=float(d.get("damping", 0.2)),
            base_mass=float(d.get("base_mass_kg", 0.5)),
            movable_mass=float(d.get("movable_mass_kg", 0.2)),
            swap_base_movable=(d.get("base_link") == "movable"),
            reasoning=str(d.get("reasoning", "")),
            from_mllm=True,
        )

    # -- generation -------------------------------------------------------

    def generate(self, out_dir: str, params: Optional[URDFParams] = None,
                 marked_views=None, movable_name: str = "lid",
                 base_name: str = "body") -> Dict:
        os.makedirs(out_dir, exist_ok=True)
        params = params or self.recommend_params(marked_views, movable_name,
                                                 base_name)
        movable, base = self.movable, self.base
        if params.swap_base_movable:
            movable, base = base, movable
            movable_name, base_name = base_name, movable_name

        hinge = HingeDetector(movable, base, self.contact_margin,
                              trim=self.hinge_trim,
                              device=self.device).detect()
        translation = HingeDetector.translation_to_origin(hinge)
        movable_c = movable.translated(translation)
        base_c = base.translated(translation)

        base_file = f"{base_name}_centered.glb"
        movable_file = f"{movable_name}_centered.glb"
        save_mesh(os.path.join(out_dir, base_file), base_c)
        save_mesh(os.path.join(out_dir, movable_file), movable_c)

        builder = URDFBuilder(self.robot_name)
        builder.add_link(base_name, base_file, color=(0.8, 0.6, 0.4, 1.0),
                         mass=params.base_mass)
        builder.add_link(movable_name, movable_file, color=(0.6, 0.8, 0.4, 1.0),
                         mass=params.movable_mass)
        builder.add_revolute_joint(
            "hinge", parent=base_name, child=movable_name, axis=hinge.axis,
            origin_xyz=(0.0, 0.0, 0.0), lower=params.lower, upper=params.upper,
            effort=params.effort, velocity=params.velocity,
            friction=params.friction, damping=params.damping)
        urdf_path = os.path.join(out_dir, f"{self.robot_name}.urdf")
        builder.save(urdf_path)

        metadata = {
            "robot_name": self.robot_name,
            "files": {
                "urdf": os.path.basename(urdf_path),
                "base_mesh": base_file,
                "movable_mesh": movable_file,
            },
            "hinge": {
                "original_position": hinge.position.tolist(),
                "axis": hinge.axis.tolist(),
                "axis_confidence": hinge.confidence,
                "translation_applied": translation.tolist(),
            },
            "joint_limits": {
                "lower": params.lower,
                "upper": params.upper,
                "lower_deg": float(np.degrees(params.lower)),
                "upper_deg": float(np.degrees(params.upper)),
            },
            "dynamics": {
                "effort": params.effort,
                "velocity": params.velocity,
                "friction": params.friction,
                "damping": params.damping,
            },
            "mllm_recommendations": {
                "object_type": params.object_type,
                "reasoning": params.reasoning,
                "parameters_used": params.from_mllm,
            },
        }
        with open(os.path.join(out_dir, "metadata.json"), "w") as fh:
            json.dump(metadata, fh, indent=2)
        metadata["hinge_result"] = hinge
        metadata["urdf_path"] = urdf_path
        return metadata
