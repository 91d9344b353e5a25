"""Tile-binned rasterization path (binning + compositing kernel).

Pipeline: project -> bin_and_gather_packed (depth-ordered per-tile
blocks) -> per-tile composite -> untile. The composite is `Composite`,
the hand-written CUDA forward and backward kernels on the card and their
plain torch versions on the CPU, so the path is differentiable: the
per-Gaussian gradient is the transpose of the binner's row gather
(`packed[sel]`), accumulated by torch autograd.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from robosimgs_tpu_torch.render.binning import bin_and_gather_packed
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.gathered import tile_image, untile
from robosimgs_tpu_torch.render.kernels import Composite
from robosimgs_tpu_torch.render.project import Projected
from robosimgs_tpu_torch.render.tiles import num_tiles


def composite_tiled(
    proj: Projected,
    width: int,
    height: int,
    cfg: RenderConfig = RenderConfig(),
    background: Optional[torch.Tensor] = None,
    return_stats: bool = False,
    depth_limit: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Composite projected splats via the tile-binned path.

    depth_limit: optional (H, W) per-pixel max depth (e.g. a rasterized
    mesh's z-buffer) — Gaussians behind it are occluded.
    """
    tiles_x, tiles_y = num_tiles(width, height, cfg.tile_size)
    geom, feat, counts, stats = bin_and_gather_packed(proj, width, height, cfg)

    dlim = None   # the kernel's occlusion test is off without a limit
    if depth_limit is not None:
        dlim = tile_image(depth_limit.detach(), tiles_x, tiles_y,
                          cfg.tile_size, pad_value=float("inf"))
    out = composite_from_tiles(geom, feat, counts, width, height, cfg,
                               background, dlim,
                               normal_mode=_normal_mode(proj))
    if return_stats:
        out["stats"] = stats
    return out


def _normal_mode(proj: Projected) -> str:
    """Which feat rows carry splat normals (see binning.pack16):
    "xyz" = rows 5/6/7, "xy" = rows 5/6 with nz reconstructed (the
    absgrad probe owns row 7), "none" = no normal rendering."""
    if proj.normals is None:
        return "none"
    return "xy" if proj.abs_probe is not None else "xyz"


def _normal_map(img: torch.Tensor, acc_a: torch.Tensor, mode: str) -> torch.Tensor:
    """(…, 8)-channel composited image -> (…, 3) unit camera-space
    normal map. In "xy" mode nz is reconstructed from the accumulated
    alpha (|Σw·n| = Σw exactly when a pixel's contributors share one
    normal; elsewhere an under-estimate that still orders alignment
    correctly)."""
    sx, sy = img[..., 5], img[..., 6]
    if mode == "xyz":
        sz = img[..., 7]
    else:
        # eps inside the sqrt: its derivative at a clamped 0 stays finite
        sz = -torch.sqrt(torch.clamp_min(acc_a * acc_a - sx * sx - sy * sy,
                                         1e-24))
    n = torch.stack([sx, sy, sz], -1)
    # rsqrt of a clamped square: zero vectors (empty pixels) normalize
    # to 0 instead of NaN
    sq = torch.sum(n * n, -1, keepdim=True)
    return n * torch.rsqrt(torch.clamp_min(sq, 1e-16))


def composite_from_tiles(
    geom: torch.Tensor,            # (T, 8, K)
    feat: torch.Tensor,            # (T, 8, K)
    counts: torch.Tensor,          # (T,) int32
    width: int,
    height: int,
    cfg: RenderConfig = RenderConfig(),
    background: Optional[torch.Tensor] = None,
    dlim: Optional[torch.Tensor] = None,    # (T, P) per-pixel depth limits
    normal_mode: str = "none",
) -> Dict[str, torch.Tensor]:
    """Composite pre-gathered per-tile feature blocks into an image.

    composite_tiled is bin_and_gather_packed + this. normal_mode
    ("none"/"xyz"/"xy", see _normal_mode): adds a "normal" unit-vector
    map to the output when feat rows carry splat normals.
    """
    if background is None:
        background = torch.zeros((3,), dtype=geom.dtype, device=geom.device)
    tiles_x, tiles_y = num_tiles(width, height, cfg.tile_size)

    has_dlim = dlim is not None
    out_tiles = Composite.apply(
        geom, feat, counts.detach(),
        dlim.detach()[..., None].contiguous() if has_dlim else None,
        tiles_x, cfg, 0, has_dlim)

    img = untile(out_tiles, tiles_x, tiles_y, width, height, cfg.tile_size)
    acc_a = img[..., 4]
    rgb = img[..., :3] + (1.0 - acc_a)[..., None] * background.to(img.device)
    out = {"rgb": rgb, "alpha": acc_a, "depth": img[..., 3]}
    if normal_mode != "none":
        out["normal"] = _normal_map(img, acc_a, normal_mode)
    return out
