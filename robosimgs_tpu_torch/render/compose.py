"""Depth-merged compositing of Gaussian splats and posed triangle meshes.

A port of robosimgs_tpu/render/compose.py, the render core of simulated
data generation: the posed object meshes are z-buffered first; the splat
background then composites with the mesh depth as a per-pixel occlusion
limit (splats behind a surface are culled per pixel), and the remaining
transmittance falls through to the mesh color, or to the background
color where no mesh covers the pixel. On a CUDA device the splat half
goes through the compositing kernel (`composite_tiled` with the depth
limit, csrc/composite_fwd.cu); on the CPU through the reference
compositor, or with impl="tiled" through the kernel's plain version.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.core.types import Gaussians
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.mesh_raster import MeshRasterConfig, rasterize_mesh
from robosimgs_tpu_torch.render.project import project
from robosimgs_tpu_torch.render.reference import composite_reference
from robosimgs_tpu_torch.render.tiled import composite_tiled


def merge_mesh_layers(layers: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Merge several rasterized mesh layers by nearest depth (an earlier
    layer wins a tie)."""
    out = layers[0]
    for nxt in layers[1:]:
        closer = nxt["depth"] < out["depth"]
        out = {
            "rgb": torch.where(closer[..., None], nxt["rgb"], out["rgb"]),
            "depth": torch.minimum(out["depth"], nxt["depth"]),
            "mask": out["mask"] | nxt["mask"],
            "face_id": torch.where(closer, nxt["face_id"], out["face_id"]),
        }
    return out


def render_composite(
    gaussians: Gaussians,
    camera: Camera,
    meshes: List[Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]],
    cfg: RenderConfig = RenderConfig(),
    mesh_cfg: MeshRasterConfig = MeshRasterConfig(),
    background: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> Dict[str, torch.Tensor]:
    """Render splat background + posed meshes, depth-merged, on the
    device of the gaussians' tensors (meshes and camera are moved there).

    meshes: list of (vertices (V,3) world-space, faces (F,3),
    vertex_colors (V,3) or None). impl: "tiled" (the compositing
    kernel), "reference", or "auto" = "tiled" for CUDA tensors, else
    "reference". Returns rgb, alpha (splat alpha), depth (mesh depth
    where present), splat_depth, mesh_mask, face_id.
    """
    dev = gaussians.device
    if background is None:
        background = torch.zeros((3,), device=dev)
    if impl == "auto":
        impl = "tiled" if dev.type == "cuda" else "reference"
    if impl not in ("tiled", "reference"):
        raise ValueError(f"unknown impl {impl!r}")
    camera = camera.to(dev)

    H, W = camera.height, camera.width
    if meshes:
        layers = [rasterize_mesh(v.to(dev), f.to(dev), camera,
                                 vertex_colors=None if c is None else c.to(dev),
                                 cfg=mesh_cfg)
                  for (v, f, c) in meshes]
        mesh_out = merge_mesh_layers([
            {k: l[k] for k in ("rgb", "depth", "mask", "face_id")} for l in layers])
        depth_limit = mesh_out["depth"]
    else:
        mesh_out = {
            "rgb": torch.zeros((H, W, 3), device=dev),
            "depth": torch.full((H, W), math.inf, device=dev),
            "mask": torch.zeros((H, W), dtype=torch.bool, device=dev),
            "face_id": torch.full((H, W), -1, dtype=torch.long, device=dev),
        }
        depth_limit = None

    proj = project(gaussians, camera, cfg)
    zero_bg = torch.zeros((3,), device=dev)
    composite = composite_reference if impl == "reference" else composite_tiled
    splat = composite(proj, W, H, cfg, zero_bg, depth_limit=depth_limit)

    # transmittance falls through to mesh surface, then to background
    behind = torch.where(mesh_out["mask"][..., None], mesh_out["rgb"],
                         background.to(dev))
    rgb = splat["rgb"] + (1.0 - splat["alpha"])[..., None] * behind
    return {
        "rgb": rgb,
        "alpha": splat["alpha"],
        "depth": mesh_out["depth"],
        "splat_depth": splat["depth"],
        "mesh_mask": mesh_out["mask"],
        "face_id": mesh_out["face_id"],
    }
