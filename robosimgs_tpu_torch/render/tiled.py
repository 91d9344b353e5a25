"""Tile-binned rasterization path (binning + compositing kernel).

Pipeline: project -> bin_and_gather_packed (depth-ordered per-tile
blocks) -> per-tile composite -> untile. The composite is `Composite`,
the hand-written CUDA forward and backward kernels on the card and their
plain torch versions on the CPU, so the path is differentiable: the
per-Gaussian gradient is the transpose of the binner's row gather
(`packed[sel]`), accumulated by torch autograd.

`composite_tiled_batch` composites several cameras at once: each camera
is binned on its own, and the C x T tiles are concatenated on the tile
axis and composited by one launch of the forward kernel (and one of the
backward), tile t taking the pixel coordinates of tile t % T.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from robosimgs_tpu_torch.render.binning import BinStats, bin_and_gather_packed
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.gathered import (composite_gathered,
                                                 tile_image, untile)
from robosimgs_tpu_torch.render.kernels import Composite
from robosimgs_tpu_torch.render.project import Projected
from robosimgs_tpu_torch.render.tiles import num_tiles
from robosimgs_tpu_torch.utils.profiling import span


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
    with span("splat.bin"):
        geom, feat, counts, stats = bin_and_gather_packed(proj, width,
                                                          height, cfg)

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

    composite_tiled is bin_and_gather_packed + this; the unpacked
    binner's blocks (binning.bin_gaussians + gather_tile_features) come
    here too. normal_mode
    ("none"/"xyz"/"xy", see _normal_mode): adds a "normal" unit-vector
    map to the output when feat rows carry splat normals.
    """
    tiles_x, tiles_y = num_tiles(width, height, cfg.tile_size)

    has_dlim = dlim is not None
    with span("splat.composite"):
        out_tiles = Composite.apply(
            geom, feat, counts.detach(),
            dlim.detach()[..., None].contiguous() if has_dlim else None,
            tiles_x, cfg, 0, has_dlim)
        img = untile(out_tiles, tiles_x, tiles_y, width, height,
                     cfg.tile_size)
        return _image_outputs(img, background, normal_mode)


def _image_outputs(img: torch.Tensor, background: Optional[torch.Tensor],
                   normal_mode: str) -> Dict[str, torch.Tensor]:
    """(..., H, W, 8) composited channels -> rgb over the background
    (black if None), alpha, depth and (normal_mode not "none") the
    normal map."""
    if background is None:
        background = img.new_zeros((3,))
    acc_a = img[..., 4]
    rgb = img[..., :3] + (1.0 - acc_a)[..., None] * background.to(img.device)
    out = {"rgb": rgb, "alpha": acc_a, "depth": img[..., 3]}
    if normal_mode != "none":
        out["normal"] = _normal_map(img, acc_a, normal_mode)
    return out


def stack_projected(projs: Sequence[Projected]) -> Projected:
    """One Projected with a leading camera axis (C, N, ...) from one per
    camera (the JAX package stacks them with tree.map)."""
    fields = {}
    for f in dataclasses.fields(Projected):
        vals = [getattr(p, f.name) for p in projs]
        fields[f.name] = None if vals[0] is None else torch.stack(vals)
    return Projected(**fields)


def _camera(projs: Projected, c: int) -> Projected:
    return Projected(**{f.name: None if getattr(projs, f.name) is None
                        else getattr(projs, f.name)[c]
                        for f in dataclasses.fields(Projected)})


def composite_tiled_batch(
    projs: Projected,
    width: int,
    height: int,
    cfg: RenderConfig = RenderConfig(),
    background: Optional[torch.Tensor] = None,
    compositor: str = "kernel",
    return_stats: bool = False,
    depth_limit: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Multi-camera composite: `projs` has a leading camera axis (C, ...)
    (`stack_projected`). Returns rgb/alpha/depth (and the normal map
    where the splats carry normals) with a leading camera axis, and with
    return_stats each camera's BinStats stacked (C,). depth_limit is
    (C, H, W) if given.

    Each camera is binned by `bin_and_gather_packed` (a loop: the JAX
    package's vmap is the same arithmetic per camera). compositor
    "kernel" composites the C*T tiles in one `Composite` call (the
    forward and backward kernels on the card, their plain versions on
    the CPU: the JAX package's "pallas"); "gathered" runs
    `composite_gathered` with each tile's within-image index (its "jnp").
    """
    tiles_x, tiles_y = num_tiles(width, height, cfg.tile_size)
    n_cam = projs.means2d.shape[0]
    with span("splat.bin"):
        binned = [bin_and_gather_packed(_camera(projs, c), width, height,
                                        cfg)
                  for c in range(n_cam)]
    T = binned[0][2].shape[0]
    P = cfg.tile_size * cfg.tile_size
    geom = torch.cat([b[0] for b in binned])                # (C*T, 8, K)
    feat = torch.cat([b[1] for b in binned])
    counts = torch.cat([b[2] for b in binned]).detach()

    dlim = None   # the kernels' occlusion test is off without a limit
    if depth_limit is not None:
        dlim = torch.cat([tile_image(d.detach(), tiles_x, tiles_y,
                                     cfg.tile_size, pad_value=float("inf"))
                          for d in depth_limit])            # (C*T, P)
    if compositor == "kernel":
        with span("splat.composite"):
            out_tiles = Composite.apply(
                geom, feat, counts,
                None if dlim is None else dlim[..., None].contiguous(),
                tiles_x, cfg, T, dlim is not None)
    elif compositor == "gathered":
        t_idx = torch.arange(n_cam * T, device=geom.device) % T
        out_tiles = composite_gathered(geom, feat, counts, tiles_x, cfg, dlim,
                                       t_idx=t_idx)
    else:
        raise ValueError(f"unknown compositor {compositor!r}")

    imgs = torch.stack([untile(o, tiles_x, tiles_y, width, height,
                               cfg.tile_size)
                        for o in out_tiles.reshape(n_cam, T, 8, P)])
    out = _image_outputs(imgs, background, _normal_mode(projs))
    if return_stats:
        out["stats"] = BinStats(**{
            f.name: torch.stack([getattr(b[3], f.name) for b in binned])
            for f in dataclasses.fields(BinStats)})
    return out
