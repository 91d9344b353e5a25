"""Part segmentation: 2D masks -> split part meshes.

A port of robosimgs_tpu/artic/segmentation.py, the redesign of the
upstream RoboSimGS interactive segmenter
(`Articulation/segmentation/interactive_segmenter.py`): point selection
-> multi-view rendering -> view choice -> part naming -> mask
generation and ranking -> face-centroid projection split, headless and
with every model call behind an interface (artic/mllm.py). Artifact
contract kept (selected_points.json, clip_prompts.json,
mask_{COLOR}_{view}.npy, part_{COLOR}.glb, camera_params.json, the
debug candidate grids).

The views and part silhouettes render on the Segmenter's device (by
default the card) and the mask model runs there; the face labelling
stays host numpy, as in the JAX package, so that labels are equal. The
OpenCV calls are utils/morphology.py's stand-ins; camera scalars leave
the device before numpy reads them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple  # noqa: F401

import numpy as np
import torch

from robosimgs_tpu_torch.artic.mllm import (ImageTextScorer, MaskGenerator,
                                            MLLMClient, MLLMError,
                                            extract_json, with_retry)
from robosimgs_tpu_torch.artic.render_views import (MARKER_COLORS,
                                                    render_canonical_views,
                                                    report_mesh_stats)
from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.utils import morphology
from robosimgs_tpu_torch.utils.meshio import Mesh, save_mesh


def nearest_vertex(mesh: Mesh, point: np.ndarray) -> int:
    """Snap a 3D point to the nearest mesh vertex (the non-GUI
    replacement for the upstream Open3D picking)."""
    d2 = ((mesh.vertices - np.asarray(point, np.float32)) ** 2).sum(1)
    return int(d2.argmin())


def dilate_mask(mask: np.ndarray, px: int) -> np.ndarray:
    """Binary dilation by `px` pixels (upstream default 10)."""
    if px <= 0:
        return mask
    return morphology.dilate(mask, px)


def project_points(points: np.ndarray, camera: Camera) -> Tuple[np.ndarray, np.ndarray]:
    """World points -> (u, v) pixel coords + in-front mask."""
    camera = camera.to("cpu")
    w2c = camera.w2c.numpy()
    p = points @ w2c[:3, :3].T + w2c[:3, 3]
    z = p[:, 2]
    in_front = z > 1e-6
    zs = np.where(in_front, z, 1.0)
    u = float(camera.fx) * p[:, 0] / zs + float(camera.cx) - 0.5
    v = float(camera.fy) * p[:, 1] / zs + float(camera.cy) - 0.5
    return np.stack([u, v], -1), in_front


def split_mesh_by_mask(mesh: Mesh, mask: np.ndarray, camera: Camera,
                       depth: Optional[np.ndarray] = None,
                       mask_b: Optional[np.ndarray] = None
                       ) -> Tuple[Mesh, Mesh, np.ndarray]:
    """Split by projecting face centroids into a (H, W) bool mask.

    Without `depth`: faces whose centroid lands inside the mask go to
    part A; everything else (including out-of-view faces) to part B —
    the upstream assignment rule
    (interactive_segmenter.py:1354-1420), vectorized.

    With `depth` (the view's z-buffer): VISIBILITY-AWARE split — only
    faces the camera actually sees take their label from the mask;
    occluded / out-of-view faces inherit the label of the nearest
    visible centroid. This fixes the upstream rule's systematic error
    that everything BEHIND a part (the box wall behind an open lid)
    falls into its mask and gets mis-assigned, while self-occluded
    back faces of the part itself still label correctly.

    Returns (part_a, part_b, face_in_a)."""
    H, W = mask.shape
    cent = mesh.face_centroids()
    uv, in_front = project_points(cent, camera)
    ui = np.round(uv[:, 0]).astype(np.int64)
    vi = np.round(uv[:, 1]).astype(np.int64)
    in_bounds = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H) & in_front
    uic = np.clip(ui, 0, W - 1)
    vic = np.clip(vi, 0, H - 1)
    hit = np.zeros(mesh.faces.shape[0], bool)
    hit[in_bounds] = mask[vic[in_bounds], uic[in_bounds]]
    if depth is not None:
        w2c = camera.to("cpu").w2c.numpy()
        z = cent @ w2c[2, :3] + w2c[2, 3]
        dz = depth[vic, uic]
        visible = in_bounds & np.isfinite(dz) & (z <= dz * 1.01 + 1e-4)
        if mask_b is not None:
            # TWO-mask split (upstream keeps a mask per color,
            # simple_segmenter segmentation_results): part B's mask
            # carves ambiguity out of A's — a visible face BOTH masks
            # claim (the junction band where A's dilation bleeds onto
            # B's surface) is unlabeled and propagates from the nearest
            # confident face in 3D; everywhere else the single-mask
            # complement rule stands.
            hit_b = np.zeros(mesh.faces.shape[0], bool)
            hit_b[in_bounds] = mask_b[vic[in_bounds], uic[in_bounds]]
            confident = visible & ~(hit & hit_b)
        else:
            confident = visible
        hit = _propagate_nearest(cent, hit, confident)
    return mesh.submesh(hit), mesh.submesh(~hit), hit


def _propagate_nearest(cent: np.ndarray, hit: np.ndarray,
                       labeled: np.ndarray) -> np.ndarray:
    """Unlabeled faces inherit the nearest labeled centroid's label
    (chunked argmin NN, labeled set subsampled to bound cost)."""
    if not labeled.any() or labeled.all():
        return hit
    hit = hit.copy()
    lab = np.nonzero(labeled)[0]
    if len(lab) > 5000:
        lab = lab[np.linspace(0, len(lab) - 1, 5000).astype(int)]
    lab_c = cent[lab].astype(np.float32)
    lab_hit = hit[lab]
    todo = np.nonzero(~labeled)[0]
    for s in range(0, len(todo), 2048):
        idx = todo[s:s + 2048]
        d2 = ((cent[idx].astype(np.float32)[:, None, :]
               - lab_c[None]) ** 2).sum(-1)
        hit[idx] = lab_hit[d2.argmin(1)]
    return hit


def _erode_mask(mask: np.ndarray, px: int) -> np.ndarray:
    if px <= 0:
        return mask
    return morphology.erode(mask, px)


def fuse_multiview_labels(mesh: Mesh, observations: Sequence[Dict],
                          dilate_px: int = 0) -> np.ndarray:
    """Multi-view part-A/part-B face labeling by weighted voting.

    Each observation is {"mask": dilated part-A mask, "camera", "depth",
    optional "mask_b": part-B's own mask}. Per view, a face votes:
      - A when visible and inside the mask's ERODED core (undoing the
        dilation the pick stage applied — the core is the confident
        claim, the dilation ring is not);
      - B when visible and outside even the DILATED mask (or inside
        mask_b's core);
    weighted by frontality |cos(face normal, direction to camera)| — a
    face seen face-on in one view outvotes the same face seen edge-on
    in another, which is exactly the junction-band failure mode of a
    single view. Faces with no votes propagate from the nearest labeled
    face in 3D (same rule as the single-view split)."""
    F = mesh.faces.shape[0]
    cent = mesh.face_centroids()
    normals = mesh.face_normals()
    score_a = np.zeros(F)
    score_b = np.zeros(F)
    for ob in observations:
        mask, cam, depth = ob["mask"], ob["camera"].to("cpu"), ob["depth"]
        H, W = mask.shape
        uv, in_front = project_points(cent, cam)
        ui = np.clip(np.round(uv[:, 0]).astype(np.int64), 0, W - 1)
        vi = np.clip(np.round(uv[:, 1]).astype(np.int64), 0, H - 1)
        inb = (in_front & (uv[:, 0] >= 0) & (uv[:, 0] <= W - 1)
               & (uv[:, 1] >= 0) & (uv[:, 1] <= H - 1))
        w2c = cam.w2c.numpy()
        z = cent @ w2c[2, :3] + w2c[2, 3]
        dz = depth[vi, ui]
        visible = inb & np.isfinite(dz) & (z <= dz * 1.01 + 1e-4)
        eye = cam.origin.numpy()
        to_cam = eye[None, :] - cent
        to_cam /= np.clip(np.linalg.norm(to_cam, axis=1, keepdims=True),
                          1e-12, None)
        w = np.abs((normals * to_cam).sum(1))
        core = _erode_mask(mask, dilate_px)
        # distance-to-boundary confidence: a claim deep inside the core
        # (or far outside the dilation) is trustworthy; one hugging the
        # mask edge is exactly the junction-band error source — the
        # mask itself over-claims by a few px there, so boundary-adjacent
        # votes must not outweigh a clean far-from-edge vote from
        # another view (r5; cuts openbox lid over-assignment vs r4)
        tau = float(max(dilate_px, 4))
        d_in = morphology.distance_transform_l2_3(core)
        d_out = morphology.distance_transform_l2_3(~mask)
        conf_a = np.zeros(F)
        conf_a[inb] = np.minimum(d_in[vi[inb], ui[inb]] / tau, 1.0)
        conf_b = np.zeros(F)
        conf_b[inb] = np.minimum(d_out[vi[inb], ui[inb]] / tau, 1.0)
        in_core = np.zeros(F, bool)
        in_core[inb] = core[vi[inb], ui[inb]]
        in_dilated = np.zeros(F, bool)
        in_dilated[inb] = mask[vi[inb], ui[inb]]
        score_a += np.where(visible & in_core, w * conf_a, 0.0)
        score_b += np.where(visible & ~in_dilated, w * conf_b, 0.0)
        mb = ob.get("mask_b")
        if mb is not None:
            core_b = _erode_mask(mb, dilate_px)
            d_in_b = morphology.distance_transform_l2_3(core_b)
            conf_bb = np.zeros(F)
            conf_bb[inb] = np.minimum(d_in_b[vi[inb], ui[inb]] / tau, 1.0)
            in_core_b = np.zeros(F, bool)
            in_core_b[inb] = core_b[vi[inb], ui[inb]]
            score_b += np.where(visible & in_core_b, w * conf_bb, 0.0)
    hit = score_a > score_b
    labeled = (score_a + score_b) > 0
    hit = _propagate_nearest(cent, hit, labeled)
    # isolated mislabeled faces (views disagreeing off the junction)
    # create spurious zero-distance "contacts" that corrupt the hinge
    # PCA downstream — smooth them out by edge-adjacency majority
    return smooth_face_labels(mesh, hit)


def smooth_face_labels(mesh: Mesh, hit: np.ndarray,
                       iterations: int = 5) -> np.ndarray:
    """Flip faces whose edge-adjacent neighbors strictly outvote their
    label (island removal; ties keep the current label)."""
    f = mesh.faces
    edges = np.sort(np.concatenate(
        [f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
    fid = np.tile(np.arange(f.shape[0]), 3)
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    e_s, f_s = edges[order], fid[order]
    same = (e_s[1:] == e_s[:-1]).all(1)       # shared manifold edges
    pa, pb = f_s[:-1][same], f_s[1:][same]    # adjacent face pairs
    hit = hit.copy()
    for _ in range(iterations):
        votes_a = np.zeros(f.shape[0], np.int32)   # neighbors saying A
        votes_n = np.zeros(f.shape[0], np.int32)   # neighbor count
        np.add.at(votes_a, pa, hit[pb].astype(np.int32))
        np.add.at(votes_a, pb, hit[pa].astype(np.int32))
        np.add.at(votes_n, pa, 1)
        np.add.at(votes_n, pb, 1)
        new = np.where(votes_a * 2 > votes_n, True,
                       np.where((votes_n - votes_a) * 2 > votes_n,
                                False, hit))
        if (new == hit).all():
            break
        hit = new
    return hit


def split_mesh_by_points(mesh: Mesh, points: np.ndarray
                         ) -> Tuple[Mesh, Mesh, np.ndarray]:
    """Geometric fallback split: assign each face to the nearest of two
    3D seed points (no mask/model needed). Returns (part_a, part_b,
    face_in_a) with part_a = faces nearest points[0]."""
    c = mesh.face_centroids()
    d0 = ((c - np.asarray(points[0], np.float32)) ** 2).sum(1)
    d1 = ((c - np.asarray(points[1], np.float32)) ** 2).sum(1)
    hit = d0 <= d1
    return mesh.submesh(hit), mesh.submesh(~hit), hit


def mask_from_part(part: Mesh, camera: Camera) -> np.ndarray:
    """Render a part's silhouette on the camera's device into a (H, W)
    bool mask (used to keep the mask_{COLOR}_{view}.npy artifact contract
    when the split came from 3D geometry rather than a 2D mask). The
    default MeshRasterConfig, as in the JAX package: triangles its
    binning drops are reported on stderr, the pixels kept."""
    from robosimgs_tpu_torch.render.mesh_raster import (MeshRasterConfig,
                                                        rasterize_mesh)

    if part.faces.shape[0] == 0:
        return np.zeros((camera.height, camera.width), bool)
    dev = camera.c2w.device
    with torch.no_grad():
        out = rasterize_mesh(torch.as_tensor(part.vertices, device=dev),
                             torch.as_tensor(part.faces, device=dev), camera)
    report_mesh_stats("mask_from_part", out["stats"], MeshRasterConfig())
    return out["mask"].cpu().numpy()


@dataclasses.dataclass
class SegmentationResult:
    parts: Dict[str, Mesh]               # color name -> mesh
    prompts: Dict[str, str]              # color name -> part name
    best_view: str
    masks: Dict[str, np.ndarray]         # color name -> (H, W) bool


class Segmenter:
    """Headless part segmenter with pluggable model backends.

    All decisions (best view, part names, candidate mask choice) can be
    supplied directly (scripted mode), or delegated to an MLLM client;
    mask candidates come from a MaskGenerator (SAM's role), ranked by an
    ImageTextScorer (CLIP's role). The views, the blur prompt and the
    default mask model run on `device`.
    """

    def __init__(
        self,
        mesh: Mesh,
        out_dir: Optional[str] = None,
        mask_generator: Optional[MaskGenerator] = None,
        scorer: Optional[ImageTextScorer] = None,
        mllm: Optional[MLLMClient] = None,
        resolution: int = 800,
        mask_dilate_px: int = 10,
        min_mask_area: float = 0.0,
        max_mask_area: float = 0.7,
        view_names: Optional[Sequence[str]] = None,
        visual_prompt: str = "blur",
        mllm_masks: bool = False,
        fusion_views: int = 1,
        device="cuda",
    ):
        self.mesh = mesh
        self.device = torch.device(device)
        self.out_dir = out_dir
        self.mask_generator = mask_generator
        self.scorer = scorer
        self.mllm = mllm
        self.resolution = resolution
        self.mask_dilate_px = mask_dilate_px
        self.min_mask_area = min_mask_area
        self.max_mask_area = max_mask_area
        # >= 2: generate the part mask on that many geometrically-ranked
        # views and label faces by frontality-weighted multi-view voting
        # (fuse_multiview_labels) instead of the single-view split
        self.fusion_views = fusion_views
        # MLLM candidate-mask decision (the upstream GPT-automatic
        # segmentation, interactive_segmenter.py:1054-1164 /
        # simple_segmenter.py:863-946): the model picks the winning mask
        # from a numbered candidate grid with the marked views as
        # context. Opt-in (cli/articulate.py --mllm enables it);
        # scripted/scorer paths remain the default for headless runs.
        self.mllm_masks = mllm_masks
        # "blur" = FGVP blur-mask prompt before scorer ranking (the
        # upstream default when FGVP is installed,
        # interactive_segmenter.py:155-165); "white" = plain
        # white-background mask crop.
        self.visual_prompt = visual_prompt
        # None = the six axis-aligned views; the upstream
        # SimpleSegmenter style uses ("top_oblique", "bottom_oblique")
        self.view_names = view_names

    # -- stage 1: point selection ----------------------------------------

    def select_points(self, points: Sequence, snap: bool = True) -> List[Dict]:
        """points: 3D coords or vertex indices. Writes selected_points.json."""
        out = []
        for p in points:
            if np.isscalar(p) or isinstance(p, (int, np.integer)):
                idx = int(p)
            else:
                idx = nearest_vertex(self.mesh, np.asarray(p)) if snap else -1
            coord = self.mesh.vertices[idx] if idx >= 0 else np.asarray(p)
            out.append({"vertex_index": idx, "position": np.asarray(coord).tolist()})
        if self.out_dir:
            with open(os.path.join(self.out_dir, "selected_points.json"), "w") as fh:
                json.dump(out, fh, indent=2)
        return out

    # -- stage 2: multi-view rendering -----------------------------------

    def render_views(self, selected: Sequence[Dict]) -> Dict[str, Dict]:
        markers = [(np.asarray(s["position"]), MARKER_COLORS[i % len(MARKER_COLORS)][1])
                   for i, s in enumerate(selected)]
        return render_canonical_views(self.mesh, out_dir=self.out_dir,
                                      resolution=self.resolution, markers=markers,
                                      view_names=self.view_names,
                                      device=self.device)

    # -- stage 3: best-view choice ---------------------------------------

    def choose_best_view(self, views: Dict[str, Dict],
                         best_view: Optional[str] = None,
                         selected: Optional[Sequence[Dict]] = None) -> str:
        if best_view is not None:
            return best_view
        if self.mllm is None:
            if selected and len(selected) >= 2:
                return self._choose_view_geometric(views, selected)
            return "top"
        names = list(views)
        prompt = (
            "You see renders of one object from these viewpoints: "
            f"{', '.join(names)}. Pick the single viewpoint where the marked "
            "colored dots on distinct parts are most clearly visible and "
            "separated. Answer as JSON: {\"view\": \"<name>\"}."
        )
        imgs = [views[n]["marked"] for n in names]
        resp = with_retry(lambda seed: self.mllm.chat(prompt, imgs, seed=seed))
        view = extract_json(resp)["view"].lower()
        return view if view in views else names[0]

    def _choose_view_geometric(self, views: Dict[str, Dict],
                               selected: Sequence[Dict]) -> str:
        """Headless best-view scoring (the MLLM's view decision replayed
        geometrically): assign every vertex to its nearest seed point (a
        cheap part proxy), and for each view count the 8x8-px cells
        covered by each part's VISIBLE vertices (z-buffer test against
        the view's depth). Score = the SMALLEST part's visible projected
        area, zeroed if any seed point itself is occluded — an edge-on
        or hidden part (the openbox lid from 'top') scores ~0 and the
        view where every part is maskable wins."""
        verts = np.asarray(self.mesh.vertices, np.float64)
        seeds = np.stack([np.asarray(s["position"], np.float64)
                          for s in selected])
        if len(verts) > 20000:
            sub = verts[np.linspace(0, len(verts) - 1, 20000).astype(int)]
        else:
            sub = verts
        d2 = ((sub[:, None, :] - seeds[None]) ** 2).sum(-1)
        part = d2.argmin(1)                              # (V,)
        best_name, best_score = next(iter(views)), -1.0
        for name, v in views.items():
            cam, depth = v["camera"], v.get("depth")
            if depth is None:
                continue
            cam = cam.to("cpu")
            H, W = depth.shape
            w2c = cam.w2c.numpy().astype(np.float64)
            p = sub @ w2c[:3, :3].T + w2c[:3, 3]
            z = p[:, 2]
            with np.errstate(divide="ignore", invalid="ignore"):
                u = p[:, 0] / z * float(cam.fx) + float(cam.cx) - 0.5
                vv = p[:, 1] / z * float(cam.fy) + float(cam.cy) - 0.5
            ui = np.clip(np.round(u).astype(int), 0, W - 1)
            vi = np.clip(np.round(vv).astype(int), 0, H - 1)
            inb = (z > 0) & (u >= 0) & (u < W) & (vv >= 0) & (vv < H)
            slack = 0.02 * float(np.median(z[inb])) if inb.any() else 0.0
            visible = inb & (z <= depth[vi, ui] + slack)
            # seed visibility gate
            ps = seeds @ w2c[:3, :3].T + w2c[:3, 3]
            zs = ps[:, 2]
            ok = zs > 0
            us = np.where(ok, ps[:, 0] / np.where(ok, zs, 1) * float(cam.fx)
                          + float(cam.cx) - 0.5, -1)
            vs = np.where(ok, ps[:, 1] / np.where(ok, zs, 1) * float(cam.fy)
                          + float(cam.cy) - 0.5, -1)
            seeds_ok = (ok & (us >= 0) & (us < W) & (vs >= 0) & (vs < H))
            if seeds_ok.all():
                usi = np.clip(np.round(us).astype(int), 0, W - 1)
                vsi = np.clip(np.round(vs).astype(int), 0, H - 1)
                seeds_ok &= zs <= depth[vsi, usi] + slack
            if not seeds_ok.all():
                score = 0.0
            else:
                cell = (vi // 8) * (W // 8 + 1) + ui // 8
                score = min(
                    len(np.unique(cell[visible & (part == k)]))
                    for k in range(len(seeds)))
            if score > best_score:
                best_name, best_score = name, float(score)
        return best_name

    # -- stage 4: part naming --------------------------------------------

    def name_parts(self, views: Dict[str, Dict], best_view: str,
                   names: Optional[Sequence[str]] = None,
                   n_parts: int = 2) -> Dict[str, str]:
        colors = [c for c, _ in MARKER_COLORS[:n_parts]]
        if names is not None:
            prompts = dict(zip(colors, names))
        elif self.mllm is not None:
            prompt = (
                "The image shows an articulated object with colored dots "
                f"marking {n_parts} parts ({', '.join(colors)}). Name each "
                "part with a short noun phrase. Answer as JSON: "
                '{"RED": "<part name>", "GREEN": "<part name>"}.'
            )
            resp = with_retry(lambda seed: self.mllm.chat(
                prompt, [views[best_view]["marked"]], seed=seed))
            parsed = extract_json(resp)
            prompts = {c: str(parsed.get(c, f"part {i}"))
                       for i, c in enumerate(colors)}
        else:
            prompts = {c: f"part {i}" for i, c in enumerate(colors)}
        if self.out_dir:
            with open(os.path.join(self.out_dir, "clip_prompts.json"), "w") as fh:
                json.dump(prompts, fh, indent=2)
        return prompts

    # -- stage 5: mask generation + selection ----------------------------

    def generate_candidates(self, image: np.ndarray,
                            prompt: Optional[str] = None,
                            marker_uv: Optional[Tuple[float, float]] = None
                            ) -> List[np.ndarray]:
        """Generate + area-filter candidate masks, ranked best-first by
        the scorer when one is configured (upstream presents
        CLIP-sorted candidates to the model,
        interactive_segmenter.py:901-903).

        With no mask_generator configured, the checked-in learned model
        (artic/masknet) is loaded on first use — the counterpart of the
        upstream segmenter shipping with SAM by default
        (interactive_segmenter.py:140-151)."""
        if self.mask_generator is None:
            from robosimgs_tpu_torch.artic.masknet import (DEFAULT_WEIGHTS,
                                                           MaskNetGenerator)
            if not os.path.exists(DEFAULT_WEIGHTS):
                raise ValueError(
                    "no mask generator backend configured and no masknet "
                    "weights found — pass mask_generator= or train them "
                    "with artic/masknet.py::train_masknet")
            self.mask_generator = MaskNetGenerator(device=self.device)
        if marker_uv is not None:
            # point-prompted generation (SAM's interactive mode — the
            # upstream clicks the part): generators that accept a
            # prompt point produce marker-focused candidates first
            try:
                candidates = self.mask_generator.generate(image,
                                                          point=marker_uv)
            except TypeError:
                candidates = self.mask_generator.generate(image)
        else:
            candidates = self.mask_generator.generate(image)
        hw = image.shape[0] * image.shape[1]
        candidates = [m for m in candidates
                      if self.min_mask_area * hw <= m.sum() <= self.max_mask_area * hw]
        if not candidates:
            raise ValueError("no candidate masks within area bounds")
        if self.scorer is not None and prompt is not None:
            scores = self._score_candidates(image, candidates, prompt)
            order = np.argsort(-np.asarray(scores))
            candidates = [candidates[i] for i in order]
        return candidates

    def _score_candidates(self, image: np.ndarray, candidates, prompt: str):
        """Scorer (CLIP-role) ranking over visually-prompted candidates.
        Default prompt = FGVP blur-mask (sharp inside the mask, heavy
        blur outside — upstream runs this before CLIP ranking); the
        blurred base image is computed once and reused."""
        if self.visual_prompt == "blur":
            from robosimgs_tpu_torch.artic.visual_prompt import gaussian_blur
            h = image.shape[0]
            blurred = gaussian_blur(
                torch.as_tensor(np.asarray(image, np.float32),
                                device=self.device),
                max(1.0, 100.0 * h / 800)).cpu().numpy()
            prompted = [np.where(m[..., None], image, blurred)
                        for m in candidates]
        else:
            prompted = [np.where(m[..., None], image, 1.0)
                        for m in candidates]
        return [float(self.scorer.score(im, [prompt, "background"])[0])
                for im in prompted]

    def mllm_select_candidate(
        self, image: np.ndarray, candidates: Sequence[np.ndarray],
        prompt: str, view_name: str, color_name: str = "RED",
        context_views: Optional[Dict[str, Dict]] = None,
    ) -> Optional[int]:
        """MLLM mask decision over a numbered candidate grid with the
        marked views as low-detail 3D context — the upstream
        `_gpt_select_candidate` (interactive_segmenter.py:1054-1164).

        Returns the candidate index, or None = the part is NOT visible
        in this view (model answered 0 — the caller should try another
        view). An unparseable / out-of-range answer falls back to
        candidate 0 (the scorer's top pick), as upstream does."""
        n = len(candidates)
        text = (
            "You are an expert in 3D object understanding and image "
            "segmentation quality assessment. The object is shown from "
            "context views with colored markers on different parts; the "
            f"{color_name} marker represents: \"{prompt}\".\n"
            f"TASK: select the best segmentation candidate for the "
            f"\"{prompt}\" part in the {view_name.upper()} view. The "
            f"final image shows {n} candidates labeled #1 to #{n}, each "
            "with a green overlay on the segmented region, sorted "
            "best-first by a prior score.\n"
            "Evaluation criteria: complete coverage of the part, "
            "accurate boundaries, no inclusion of other parts, correct "
            "occlusion handling.\nReturn ONLY a single number: 0 if the "
            f"\"{prompt}\" part is NOT visible in this view, else "
            f"1-{n} for the best candidate."
        )
        imgs = [v["marked"] for v in (context_views or {}).values()]
        imgs.append(self._candidate_grid_image(image, candidates))
        try:
            resp = with_retry(lambda seed: self.mllm.chat(text, imgs,
                                                          seed=seed))
            sel = int(str(resp).strip().split()[0])
        except (MLLMError, ValueError, IndexError):
            return 0                      # fall back to the top-ranked mask
        if sel == 0:
            return None
        if 1 <= sel <= n:
            return sel - 1
        return 0

    def mllm_choose_view_joint(self, views: Dict[str, Dict],
                               prompts: Dict[str, str]) -> Optional[str]:
        """Cross-view joint selection, step 1: the model sees ALL marked
        views at once and picks the view where the two parts do NOT
        overlap in 2D, with a THINKING/ANSWER protocol — upstream
        SimpleSegmenter's `_gpt_choose_best_view`
        (simple_segmenter.py:757-861). Returns view name or None."""
        names = list(views)
        parts = list(prompts.values())
        colors = list(prompts)
        text = (
            "You are analyzing an articulated object to determine the "
            "best view for segmentation. Parts: "
            + "; ".join(f"{c} marker = \"{p}\"" for c, p in
                        zip(colors, parts)) +
            f".\nViews shown, in order: {', '.join(names)}.\n"
            f"CRITICAL: the \"{parts[0]}\" and \"{parts[1]}\" parts must "
            "NOT overlap in the 2D projection of the chosen view. "
            "Examine each view: find both markers, judge whether the two "
            "part regions overlap; choose the view with least overlap, "
            "both parts visible and boundaries clear.\n"
            "Return your answer in this format:\n"
            "THINKING: [per-view analysis]\n"
            f"ANSWER: one of {', '.join(names)}"
        )
        imgs = [views[n]["marked"] for n in names]
        try:
            resp = with_retry(lambda seed: self.mllm.chat(text, imgs,
                                                          seed=seed))
        except MLLMError:
            return None
        ans = resp.split("ANSWER:")[-1].strip().lower() if "ANSWER:" in resp \
            else resp.strip().lower()
        ans = ans.split()[0] if ans.split() else ans
        return ans if ans in views else None

    def segment_part(self, image: np.ndarray, prompt: str,
                     marker_uv: Optional[Tuple[float, float]] = None,
                     chosen_index: Optional[int] = None,
                     view_name: str = "view",
                     context_views: Optional[Dict[str, Dict]] = None,
                     candidates: Optional[List[np.ndarray]] = None,
                     exclude_uvs: Optional[Sequence[Tuple[float, float]]]
                     = None) -> np.ndarray:
        """Generate candidate masks, rank, pick (scripted index, MLLM,
        marker containment, scorer rank), dilate.

        Pick priority: `chosen_index` (scripted) > MLLM decision (when
        `mllm_masks` is on) > marker containment > scorer top-1 >
        largest. If the MLLM answers "not visible" (None) the marker /
        scorer fallbacks apply — callers doing cross-view selection
        should use generate_candidates + mllm_select_candidate directly
        (see run()).

        The marker-containment pool prefers candidates that contain
        `marker_uv` AND exclude every `exclude_uvs` (the OTHER parts'
        markers — strong discriminative signal the headless flow gets
        for free); within the pool, candidates are ranked by boundary-
        edge alignment (a good mask's boundary follows shading
        discontinuities; an under-/over-shooting one cuts flat regions),
        tightest as the tie-break."""
        if candidates is None:
            candidates = self.generate_candidates(image, prompt,
                                                  marker_uv=marker_uv)
        if self.out_dir:
            self._dump_candidate_grid(image, candidates, prompt)
        best = None
        if chosen_index is not None:
            best = candidates[chosen_index]
        elif self.mllm_masks and self.mllm is not None:
            idx = self.mllm_select_candidate(image, candidates, prompt,
                                             view_name,
                                             context_views=context_views)
            if idx is not None:
                best = candidates[idx]
            # idx None = "part not visible" -> geometric fallbacks below
        if best is None:
            if marker_uv is not None:
                best = self._pick_by_markers(image, candidates, marker_uv,
                                             exclude_uvs)
            elif self.scorer is not None:
                best = candidates[0]      # already ranked best-first
            else:
                best = max(candidates, key=lambda m: m.sum())
        return dilate_mask(best, self.mask_dilate_px)

    @staticmethod
    def _edge_quality(image: np.ndarray, mask: np.ndarray) -> float:
        """Mean image-gradient magnitude along the mask boundary —
        model-free segmentation-quality proxy (0 on blank images)."""
        gray = image.mean(-1).astype(np.float32)
        gx = morphology.sobel3(gray, 1, 0)
        gy = morphology.sobel3(gray, 0, 1)
        mag = np.hypot(gx, gy)
        boundary = morphology.dilate(mask, 3) & ~morphology.erode(mask, 3)
        if not boundary.any():
            return 0.0
        return float(mag[boundary].mean())

    def _pick_by_markers(self, image, candidates, marker_uv, exclude_uvs):
        def inside(m, uv):
            u, v = int(round(uv[0])), int(round(uv[1]))
            return 0 <= v < m.shape[0] and 0 <= u < m.shape[1] and m[v, u]

        containing = [m for m in candidates if inside(m, marker_uv)]
        if containing and exclude_uvs:
            clean = [m for m in containing
                     if not any(inside(m, uv) for uv in exclude_uvs)]
            containing = clean or containing
        pool = containing or candidates
        return max(pool, key=lambda m: (self._edge_quality(image, m),
                                        -int(m.sum())))

    # -- stage 6: split + export -----------------------------------------

    def fused_labels(self, views: Dict[str, Dict], view: str,
                      mask: np.ndarray, mask_b: Optional[np.ndarray],
                      prompts: Dict[str, str],
                      selected: Sequence[Dict]) -> Optional[np.ndarray]:
        """Build multi-view observations (the chosen view's mask plus
        part-A masks generated on the next-best geometric views) and
        fuse. Returns None when no extra view yields a usable mask —
        the single-view split then proceeds unchanged."""
        obs = [{"mask": mask, "mask_b": mask_b,
                "camera": views[view]["camera"],
                "depth": views[view]["depth"]}]
        part0 = list(prompts.values())[0]
        remaining = {n: v for n, v in views.items()
                     if n != view and v.get("depth") is not None}
        while len(obs) < self.fusion_views and remaining:
            if len(selected) >= 2:
                nxt = self._choose_view_geometric(remaining, selected)
            else:
                nxt = next(iter(remaining))
            v2 = remaining.pop(nxt)
            uv2, _ = project_points(
                np.asarray([s["position"] for s in selected], np.float32),
                v2["camera"])
            try:
                m2 = self.segment_part(
                    v2["clean"], part0, marker_uv=tuple(uv2[0]),
                    view_name=nxt,
                    exclude_uvs=[tuple(u) for u in uv2[1:]])
            except (ValueError, MLLMError):
                continue
            obs.append({"mask": m2, "camera": v2["camera"],
                        "depth": v2["depth"]})
        if len(obs) < 2:
            return None
        return fuse_multiview_labels(self.mesh, obs,
                                     dilate_px=self.mask_dilate_px)

    def split_and_export(self, mask: np.ndarray, camera: Camera,
                         prompts: Dict[str, str], view_name: str,
                         depth: Optional[np.ndarray] = None,
                         mask_b: Optional[np.ndarray] = None,
                         hit: Optional[np.ndarray] = None
                         ) -> Dict[str, Mesh]:
        colors = list(prompts)
        if hit is not None:      # precomputed (multi-view fused) labels
            part_a, part_b = self.mesh.submesh(hit), self.mesh.submesh(~hit)
        else:
            part_a, part_b, _ = split_mesh_by_mask(self.mesh, mask, camera,
                                                   depth=depth, mask_b=mask_b)
        if part_a.faces.shape[0] == 0 or part_b.faces.shape[0] == 0:
            raise ValueError(
                "degenerate split: one part has no faces — the mask covers "
                "all (or none) of the projected face centroids; reduce "
                "mask_dilate_px or pick a different view")
        parts = {colors[0]: part_a, colors[1]: part_b}
        if self.out_dir:
            np.save(os.path.join(self.out_dir, f"mask_{colors[0]}_{view_name}.npy"),
                    mask)
            inv = ~mask if mask_b is None else mask_b
            np.save(os.path.join(self.out_dir, f"mask_{colors[1]}_{view_name}.npy"),
                    inv)
            for color, mesh in parts.items():
                save_mesh(os.path.join(self.out_dir, f"part_{color}.glb"), mesh)
        return parts

    def _candidate_grid_image(self, image: np.ndarray, candidates,
                              max_tiles: int = 16) -> np.ndarray:
        """Numbered candidate grid: each tile is the image with a green
        overlay on its mask and a "#N" label — the artifact the MLLM
        decides over (the upstream all_candidates grid). float32 in
        [0, 1]. The label is utils/morphology.py's bitmap font, inside the
        box of the JAX package's Hershey label; the grid equals the JAX
        package's outside those boxes."""
        tiles = []
        for i, m in enumerate(candidates[:max_tiles]):
            overlay = image.copy()
            overlay[m] = 0.5 * overlay[m] + 0.5 * np.asarray([0.1, 1.0, 0.1])
            overlay = np.ascontiguousarray(
                (np.clip(overlay, 0, 1) * 255).astype(np.uint8))
            scale = max(0.5, image.shape[0] / 400)
            morphology.stamp_label(overlay, f"#{i + 1}", (8, int(28 * scale)),
                                   scale, (255, 25, 25))
            tiles.append(overlay.astype(np.float32) / 255.0)
        cols = min(4, len(tiles))
        rows = -(-len(tiles) // cols)
        H, W = image.shape[:2]
        grid = np.ones((rows * H, cols * W, 3), np.float32)
        for i, t in enumerate(tiles):
            r, c = divmod(i, cols)
            grid[r * H:(r + 1) * H, c * W:(c + 1) * W] = t
        return grid

    def _dump_candidate_grid(self, image: np.ndarray, candidates, prompt: str):
        """Candidate-mask debug grid (the upstream observability-as-
        testing artifact dumps, SURVEY.md §4 item 3)."""
        from robosimgs_tpu_torch.cli.render import write_png

        debug_dir = os.path.join(self.out_dir, "debug")
        os.makedirs(debug_dir, exist_ok=True)
        grid = self._candidate_grid_image(image, candidates)
        safe = "".join(ch if ch.isalnum() else "_" for ch in prompt)[:40]
        write_png(os.path.join(debug_dir, f"candidates_{safe}.png"),
                  (np.clip(grid, 0, 1) * 255).astype(np.uint8))

    def load_cached(self) -> Optional[Dict]:
        """Resume support: load prior selected_points/clip_prompts/mask
        artifacts from out_dir (the upstream disk-cache resume,
        `interactive_segmenter.py:1495-1534`)."""
        if not self.out_dir:
            return None
        sp = os.path.join(self.out_dir, "selected_points.json")
        cp = os.path.join(self.out_dir, "clip_prompts.json")
        if not (os.path.exists(sp) and os.path.exists(cp)):
            return None
        cached = {"selected": json.load(open(sp)),
                  "prompts": json.load(open(cp)), "masks": {}}
        for f in os.listdir(self.out_dir):
            if f.startswith("mask_") and f.endswith(".npy"):
                color_view = f[len("mask_"):-len(".npy")]
                color, view = color_view.split("_", 1)
                cached["masks"][(color, view)] = np.load(
                    os.path.join(self.out_dir, f))
        return cached

    # -- full pipeline ----------------------------------------------------

    def run(
        self,
        points: Sequence,
        part_names: Optional[Sequence[str]] = None,
        best_view: Optional[str] = None,
        mask_index: Optional[int] = None,
        resume: bool = False,
    ) -> SegmentationResult:
        if resume:
            cached = self.load_cached()
            if cached and cached["masks"]:
                prompts = cached["prompts"]
                (color0, view), mask = next(iter(
                    ((cv, m) for cv, m in cached["masks"].items()
                     if cv[0] == list(prompts)[0])), ((None, None), None))
                if mask is not None:
                    vr = render_canonical_views(
                        self.mesh, resolution=self.resolution,
                        view_names=[view], device=self.device)[view]
                    colors = list(prompts)
                    mb = cached["masks"].get((colors[1], view))
                    # a saved complement carries no extra signal; only a
                    # real second-part mask re-enters the two-mask split
                    if mb is not None and (mb.astype(bool)
                                           == ~mask.astype(bool)).all():
                        mb = None
                    parts = self.split_and_export(
                        mask.astype(bool), vr["camera"], prompts, view,
                        depth=vr.get("depth"),
                        mask_b=None if mb is None else mb.astype(bool))
                    return SegmentationResult(
                        parts=parts, prompts=prompts, best_view=view,
                        masks={colors[0]: mask.astype(bool),
                               colors[1]: (~mask.astype(bool)
                                           if mb is None
                                           else mb.astype(bool))})
        selected = self.select_points(points)
        views = self.render_views(selected)
        mask_b = None
        joint = (self.mllm_masks and self.mllm is not None
                 and mask_index is None and best_view is None
                 and len(views) == 2)
        if joint:
            # cross-view JOINT selection (upstream SimpleSegmenter
            # select_parts_with_gpt, simple_segmenter.py:672-757):
            # candidates on BOTH views, THINKING/ANSWER view choice,
            # numbered-grid mask pick; a "not visible" verdict retries
            # the other view before the geometric fallback.
            prompts = self.name_parts(views, list(views)[0], part_names,
                                      n_parts=max(len(selected), 2))
            part0 = list(prompts.values())[0]
            cands = {v: self.generate_candidates(views[v]["clean"], part0)
                     for v in views}
            if self.out_dir:
                for v in views:
                    self._dump_candidate_grid(views[v]["clean"], cands[v],
                                              f"{part0}_{v}")
            view = self.mllm_choose_view_joint(views, prompts) \
                or next(iter(views))
            order = [view] + [v for v in views if v != view]
            mask = None
            for v in order:
                idx = self.mllm_select_candidate(
                    views[v]["clean"], cands[v], part0, v,
                    context_views=views)
                if idx is not None:
                    view, mask = v, cands[v][idx]
                    break
            if mask is None:              # model says invisible everywhere:
                view = order[0]           # tightest marker-containing mask
                cam0 = views[view]["camera"]
                uv, _ = project_points(
                    np.asarray([selected[0]["position"]], np.float32), cam0)
                u, vpx = int(round(uv[0][0])), int(round(uv[0][1]))
                pool = [m for m in cands[view]
                        if 0 <= vpx < m.shape[0] and 0 <= u < m.shape[1]
                        and m[vpx, u]] or cands[view]
                mask = min(pool, key=lambda m: m.sum())
            mask = dilate_mask(mask, self.mask_dilate_px)
            cam = views[view]["camera"]
        else:
            view = self.choose_best_view(views, best_view, selected=selected)
            prompts = self.name_parts(views, view, part_names,
                                      n_parts=max(len(selected), 2))
            cam = views[view]["camera"]
            all_uv, _ = project_points(
                np.asarray([s["position"] for s in selected], np.float32),
                cam)
            mask = self.segment_part(
                views[view]["clean"], list(prompts.values())[0],
                marker_uv=tuple(all_uv[0]), chosen_index=mask_index,
                view_name=view,
                context_views=views if self.mllm_masks else None,
                exclude_uvs=[tuple(u) for u in all_uv[1:]])
            # second-part mask (upstream keeps a mask PER color):
            # where both masks agree the split is confident; the
            # junction band they disagree on propagates in 3D. Only
            # trusted when it actually contains its own marker.
            if (mask_index is None and len(selected) >= 2
                    and not (self.mllm_masks and self.mllm is not None)):
                try:
                    mb = self.segment_part(
                        views[view]["clean"], list(prompts.values())[1],
                        marker_uv=tuple(all_uv[1]), view_name=view,
                        exclude_uvs=[tuple(all_uv[0])]
                        + [tuple(u) for u in all_uv[2:]])
                    ub, vb = (int(round(all_uv[1][0])),
                              int(round(all_uv[1][1])))
                    if (0 <= vb < mb.shape[0] and 0 <= ub < mb.shape[1]
                            and mb[vb, ub]):
                        mask_b = mb
                except ValueError:
                    pass
        fused_hit = None
        if (self.fusion_views >= 2 and len(views) > 1 and not joint
                and views[view].get("depth") is not None):
            fused_hit = self.fused_labels(views, view, mask, mask_b,
                                           prompts, selected)
        parts = self.split_and_export(mask, cam, prompts, view,
                                      depth=views[view].get("depth"),
                                      mask_b=mask_b, hit=fused_hit)
        colors = list(prompts)
        return SegmentationResult(
            parts=parts, prompts=prompts, best_view=view,
            masks={colors[0]: mask,
                   colors[1]: ~mask if mask_b is None else mask_b})
