"""Canonical multi-view rendering of a mesh for segmentation/MLLM input.

A port of robosimgs_tpu/artic/render_views.py, the stand-in for the
upstream RoboSimGS trimesh/OpenGL 6-view renderer: six axis-aligned
views (front/back/left/right/top/bottom), camera at `distance_factor` x
the bbox diagonal, fov 50°, square resolution, with optional colored
point markers; writes the same artifact contract (view_{name}.png,
view_{name}_marked.png, camera_params.json with intrinsics/c2w/
resolution). Rendering is render/mesh_raster.py's tile-binned rasterizer
on the cameras' device with headlight shading; the PNGs are written by
cli/render.py's writer (no Pillow). A view whose triangle binning
truncates or overflows renders all the same, as in the JAX package, and
says so on stderr.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.render.mesh_raster import (MeshRasterConfig,
                                                    rasterize_mesh)
from robosimgs_tpu_torch.utils.meshio import Mesh

VIEW_DIRECTIONS: Dict[str, np.ndarray] = {
    "front": np.array([0.0, -1.0, 0.0]),
    "back": np.array([0.0, 1.0, 0.0]),
    "left": np.array([-1.0, 0.0, 0.0]),
    "right": np.array([1.0, 0.0, 0.0]),
    "top": np.array([0.0, 0.0, 1.0]),
    "bottom": np.array([0.0, 0.0, -1.0]),
}

# The upstream SimpleSegmenter variant works from two oblique views;
# selectable via view_names.
OBLIQUE_DIRECTIONS: Dict[str, np.ndarray] = {
    "top_oblique": np.array([0.7, -0.7, 0.8]),
    "bottom_oblique": np.array([0.7, -0.7, -0.8]),
}
ALL_DIRECTIONS = {**VIEW_DIRECTIONS, **OBLIQUE_DIRECTIONS}

MARKER_COLORS: List[Tuple[str, Tuple[float, float, float]]] = [
    ("RED", (1.0, 0.0, 0.0)), ("GREEN", (0.0, 1.0, 0.0)),
    ("BLUE", (0.0, 0.0, 1.0)), ("YELLOW", (1.0, 1.0, 0.0)),
]


def view_camera(mesh: Mesh, direction: np.ndarray, resolution: int = 800,
                fov_deg: float = 50.0, distance_factor: float = 2.0,
                device="cuda") -> Camera:
    center = mesh.center
    diag = float(np.linalg.norm(mesh.bounds[1] - mesh.bounds[0]))
    eye = center + direction / np.linalg.norm(direction) * distance_factor * diag
    up = [0, 0, 1] if abs(direction[2]) < 0.9 else [0, 1, 0]
    return Camera.look_at(eye, center, up, fov_deg, resolution, resolution,
                          device=device)


def shade(mesh: Mesh, camera: Camera) -> np.ndarray:
    """Per-face headlight Lambertian colors (albedo from vertex colors
    or light gray; for UV-textured meshes this is the shading TERM only
    — the rasterizer multiplies the texture in per pixel)."""
    normals = mesh.face_normals()
    eye = camera.origin.cpu().numpy()
    to_cam = eye[None, :] - mesh.face_centroids()
    to_cam /= np.clip(np.linalg.norm(to_cam, axis=1, keepdims=True), 1e-9, None)
    lam = np.abs((normals * to_cam).sum(1))
    textured = mesh.uv is not None and mesh.texture is not None
    if mesh.vertex_colors is not None:
        # under a texture this is the glTF color MODULATION term — the
        # rasterizer multiplies the texture in per pixel
        albedo = mesh.vertex_colors[mesh.faces].mean(1)
    elif textured:
        albedo = np.ones((mesh.faces.shape[0], 3), np.float32)
    else:
        albedo = np.full((mesh.faces.shape[0], 3), 0.75, np.float32)
    return (albedo * (0.35 + 0.65 * lam)[:, None]).astype(np.float32)


def report_mesh_stats(tag: str, stats, cfg: MeshRasterConfig) -> None:
    """Print a rasterize_mesh call's dropped triangles on stderr (nothing
    when none were dropped)."""
    truncated, overflowed = (int(stats.truncated_gaussians),
                             int(stats.overflowed_tiles))
    if truncated or overflowed:
        print(f"{tag}: mesh binning drops triangles: {truncated} truncated "
              f"triangles (more than max_tiles_per_tri "
              f"{cfg.max_tiles_per_tri} tiles), {overflowed} overflowed tiles"
              f" (up to {int(stats.max_tile_count)} triangles a tile, tile "
              f"capacity {cfg.tile_capacity}); "
              f"render/autotune.py::mesh_demand measures the demand",
              file=sys.stderr)


def render_view(mesh: Mesh, camera: Camera,
                markers: Optional[Sequence[Tuple[np.ndarray, Tuple[float, float, float]]]] = None,
                mesh_cfg: MeshRasterConfig = MeshRasterConfig(tile_capacity=1024),
                background: float = 1.0, return_depth: bool = False,
                return_stats: bool = False):
    """Render one shaded view on the camera's device; markers are
    (world_point, rgb) dots. Returns the (H, W, 3) float32 numpy image;
    with return_depth, (img, depth (H, W), +inf on background) — the
    z-buffer the Segmenter's geometric view scoring samples for
    seed-point visibility; with return_stats, the triangle BinStats
    last. Dropped triangles are printed on stderr."""
    dev = camera.c2w.device
    face_colors = shade(mesh, camera)
    tex_kw = {}
    if mesh.uv is not None and mesh.texture is not None:
        tex_kw = dict(vertex_uvs=torch.as_tensor(mesh.uv, device=dev),
                      texture=torch.as_tensor(mesh.texture, device=dev))
    with torch.no_grad():
        out = rasterize_mesh(torch.as_tensor(mesh.vertices, device=dev),
                             torch.as_tensor(mesh.faces, device=dev),
                             camera,
                             face_colors=torch.as_tensor(face_colors,
                                                         device=dev),
                             cfg=mesh_cfg, **tex_kw)
    report_mesh_stats("render_view", out["stats"], mesh_cfg)
    rgb = out["rgb"].cpu().numpy()
    mask = out["mask"].cpu().numpy()
    img = np.where(mask[..., None], rgb, background).astype(np.float32)
    depth = out["depth"].cpu().numpy()
    if markers:
        img = _draw_markers(img, depth, camera, markers)
    res = (img, depth) if return_depth else (img,)
    if return_stats:
        res += (out["stats"],)
    return res if len(res) > 1 else img


def _draw_markers(img, depth, camera: Camera, markers, radius_px: int = 8):
    cam = camera.to("cpu")
    w2c = cam.w2c.numpy()
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)
    H, W = img.shape[:2]
    yy, xx = np.mgrid[0:H, 0:W]
    for point, color in markers:
        p = w2c[:3, :3] @ np.asarray(point) + w2c[:3, 3]
        if p[2] <= 0:
            continue
        u = fx * p[0] / p[2] + cx - 0.5
        v = fy * p[1] / p[2] + cy - 0.5
        # only draw if not occluded (allow small depth slack)
        ui, vi = int(round(u)), int(round(v))
        if not (0 <= ui < W and 0 <= vi < H):
            continue
        if np.isfinite(depth[vi, ui]) and p[2] > depth[vi, ui] + 0.05:
            continue
        circle = (xx - u) ** 2 + (yy - v) ** 2 <= radius_px**2
        img[circle] = color
    return img


def render_canonical_views(
    mesh: Mesh,
    out_dir: Optional[str] = None,
    resolution: int = 800,
    fov_deg: float = 50.0,
    distance_factor: float = 2.0,
    markers: Optional[Sequence[Tuple[np.ndarray, Tuple[float, float, float]]]] = None,
    view_names: Optional[Sequence[str]] = None,
    device="cuda",
) -> Dict[str, Dict]:
    """Render the canonical views (clean + marked) on `device`; optionally
    write view_*.png / view_*_marked.png / camera_params.json artifacts.
    view_names selects a subset / oblique variants (default: the six
    axis-aligned views). Each view's "stats" is its triangle BinStats."""
    from robosimgs_tpu_torch.cli.render import write_png

    views = {}
    cam_params = {}
    names = list(view_names) if view_names else list(VIEW_DIRECTIONS)
    for name in names:
        direction = ALL_DIRECTIONS[name]
        cam = view_camera(mesh, direction, resolution, fov_deg,
                          distance_factor, device=device)
        clean, depth, stats = render_view(mesh, cam, return_depth=True,
                                          return_stats=True)
        marked = render_view(mesh, cam, markers=markers) if markers else clean
        views[name] = {"camera": cam, "clean": clean, "marked": marked,
                       "depth": depth, "stats": stats}
        host = cam.to("cpu")
        K = np.array([[float(host.fx), 0, float(host.cx)],
                      [0, float(host.fy), float(host.cy)], [0, 0, 1.0]])
        cam_params[name] = {
            "intrinsics": K.tolist(),
            "c2w": host.c2w.numpy().tolist(),
            "resolution": [resolution, resolution],
        }
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            for tag, im in (("", clean), ("_marked", marked)):
                write_png(os.path.join(out_dir, f"view_{name}{tag}.png"),
                          (np.clip(im, 0, 1) * 255).astype(np.uint8))
    if out_dir:
        with open(os.path.join(out_dir, "camera_params.json"), "w") as fh:
            json.dump(cam_params, fh, indent=2)
    return views
