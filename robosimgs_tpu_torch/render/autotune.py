"""Capacity auto-tuning: pick lossless capacities for a scene.

A port of robosimgs_tpu/render/autotune.py. The binning capacities
(`max_tiles_per_gaussian`, `tile_capacity`) truncate when too small
(counted in BinStats, never silent). This measures a scene against
representative cameras with generous caps and returns the smallest
capacities with headroom, optionally shrinking the tile capacity to the
smallest K whose render matches the full-demand one above a PSNR gate.

Two differences from the JAX package: every probe and the returned
config keep a `tile_chunk` that divides their tile_capacity (the JAX
package probes with tile_chunk=0 and can return a config whose chunk
does not divide the gated K); and the first probe, which asks for K up
to min(N, 2^17) entries per tile, first checks that its (T, K, 16) row
gather fits the card and raises if not, never lowering K.

The mesh side (new in the port; the JAX package has no mesh capacity
tuning): `mesh_demand` reads the triangle BinStats of rasterize_mesh over
a rollout's posed links and cameras, and `mesh_tile_capacity` sizes
MeshRasterConfig.tile_capacity from it, so that no mesh tile overflows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.core.types import Gaussians
from robosimgs_tpu_torch.render.binning import (bin_and_gather_packed,
                                                per_gaussian_cover)
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.mesh_raster import (MeshRasterConfig,
                                                    rasterize_mesh)
from robosimgs_tpu_torch.render.project import project
from robosimgs_tpu_torch.render.tiled import composite_tiled
from robosimgs_tpu_torch.render.tiles import num_tiles, tile_bbox

# bytes per (tile, slot) of bin_and_gather_packed at its peak: the
# (T, K, 16) f32 gather, its copy with the padding's opacity zeroed, and
# the contiguous geom/feat blocks; plus three (T, K) int64 index arrays
_PROBE_BYTES_PER_SLOT = 3 * 16 * 4 + 3 * 8


def _round_up(x: int, step: int) -> int:
    return max(step, ((x + step - 1) // step) * step)


def _fit_chunk(cfg: RenderConfig) -> RenderConfig:
    """cfg with a tile_chunk that divides its tile_capacity (kept when it
    does; else 512 or 128, multiples of the kernel's 128-splat block)."""
    K, c = cfg.tile_capacity, cfg.tile_chunk
    if c == 0 or K % c == 0:
        return cfg
    return dataclasses.replace(cfg, tile_chunk=512 if K % 512 == 0 else 128)


def _check_probe_fits(n_tiles: int, K: int, device: torch.device) -> None:
    need = n_tiles * K * _PROBE_BYTES_PER_SLOT
    if device.type != "cuda":
        return
    # free on the device, plus what torch's allocator holds unused
    free = (torch.cuda.mem_get_info(device)[0]
            + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))
    if need > free:
        raise RuntimeError(
            f"recommend_capacities: the demand probe at K={K} over "
            f"{n_tiles} tiles needs about {need / 2**30:.1f} GiB for its "
            f"(T, K, 16) gather, and {device} has {free / 2**30:.1f} GiB "
            f"free; measure fewer or smaller views, or a scene with fewer "
            f"gaussians")


def recommend_capacities(
    gaussians: Gaussians,
    cameras: Sequence[Camera],
    base: RenderConfig = RenderConfig(),
    headroom: float = 1.5,
    gate_db: Optional[float] = None,
) -> RenderConfig:
    """Measure per-camera tile statistics and return a RenderConfig whose
    capacities are lossless for the measured views (x headroom), on the
    gaussians' device.

    tile_capacity is rounded to a multiple of 128 (the kernel's block
    size); max_tiles_per_gaussian to a multiple of 4. A two-tier sort
    split is picked when it removes at least a quarter of the key-sort
    slots.

    gate_db: when set, additionally searches for the SMALLEST
    tile_capacity whose render of the measured cameras matches the
    full-demand capacity above this PSNR (dense scenes saturate
    transmittance long before the largest per-tile demand, and overflow
    drops only the farthest entries). M and the bbox stay lossless: M
    truncation drops near tiles and is never gated away. Costs one
    render per candidate K per camera.
    """
    dev = gaussians.device
    max_cover = 0      # surviving tiles (post-cull) — sizes the M sort
    max_bbox = 0       # bbox tiles — sizes the enumeration cap
    max_count = 0
    covers = []        # per-camera survivor-cover arrays (two-tier pick)
    with torch.no_grad():
        for cam in cameras:
            proj = project(gaussians, cam, base)
            tiles_x, tiles_y = num_tiles(cam.width, cam.height, base.tile_size)
            tx0, ty0, tx1, ty1 = tile_bbox(proj.means2d, proj.radii,
                                           tiles_x, tiles_y, base.tile_size)
            bbox_cover = torch.where(
                proj.valid,
                (tx1 - tx0 + 1).clamp_min(0) * (ty1 - ty0 + 1).clamp_min(0), 0)
            max_bbox = max(max_bbox, int(bbox_cover.max()))
            # tiles the gaussian ACTUALLY hits (the exact cull removes
            # bbox corner tiles), enumerated over the full bbox
            cover = per_gaussian_cover(proj, cam.width, cam.height, base,
                                       max_tiles=max(max_bbox, 1))
            covers.append(cover)
            max_cover = max(max_cover, int(cover.max()))
            # probe with generous caps to read the true per-tile demand
            probe = _fit_chunk(dataclasses.replace(
                base,
                max_tiles_per_gaussian=_round_up(max(max_bbox, 1), 4),
                bbox_tiles_per_gaussian=0,
                tile_capacity=_round_up(
                    min(int(gaussians.num_alive), 1 << 17), 128)))
            _check_probe_fits(tiles_x * tiles_y, probe.tile_capacity, dev)
            _, _, _, stats = bin_and_gather_packed(proj, cam.width,
                                                   cam.height, probe)
            max_count = max(max_count, int(stats.max_tile_count))

    kept = _round_up(int(math.ceil(max_cover * headroom)), 4)
    bbox = _round_up(int(math.ceil(max_bbox * headroom)), 4)

    # two-tier sort pick: choose the split s minimizing total key-sort
    # slots s*N + spill_rows(s)*(kept-s), where spill_rows is the worst
    # camera's count of gaussians covering > s tiles (x headroom,
    # rounded to the 128-row spill granularity). Enabled only when it
    # removes >=25% of slots.
    n = int(gaussians.means.shape[0])
    split, frac = 0, 0.0
    if kept > 2 and n > 0:
        # one histogram per camera gives count(cover > s) for every s
        over_all = np.zeros(kept + 1, dtype=np.int64)
        for c in covers:
            hist = torch.bincount(c.clamp(0, kept).long(),
                                  minlength=kept + 1).cpu().numpy()
            over_all = np.maximum(over_all, n - np.cumsum(hist))
        base_slots = kept * n
        best = base_slots
        for s in range(2, kept - 1, 2):
            over = int(over_all[s])
            rows = min(n, _round_up(int(math.ceil(over * headroom)), 128))
            slots = s * n + rows * (kept - s)
            if slots < best:
                best, split, frac = slots, s, rows / n
        if best > 0.75 * base_slots:
            split, frac = 0, 0.0

    cfg = _fit_chunk(dataclasses.replace(
        base,
        max_tiles_per_gaussian=kept,
        # enumerate the full bbox only when the cull buys slot reduction
        bbox_tiles_per_gaussian=bbox if bbox > kept else 0,
        tile_capacity=_round_up(int(math.ceil(max_count * headroom)), 128),
        two_tier_split=split,
        two_tier_spill_frac=frac,
    ))
    if gate_db is not None:
        cfg = _fit_chunk(dataclasses.replace(
            cfg, tile_capacity=_gate_capacity(gaussians, cameras, cfg,
                                              gate_db)))
    return cfg


def _gate_capacity(gaussians: Gaussians, cameras: Sequence[Camera],
                   cfg: RenderConfig, gate_db: float) -> int:
    """Smallest K (a power-of-two multiple of 128) whose render matches
    the full-demand-capacity render above gate_db on EVERY measured
    camera. Single-tier probe configs (the two-tier split only changes
    sort work, not the kept entries)."""
    k_full = cfg.tile_capacity

    def render(cam, k):
        c = _fit_chunk(dataclasses.replace(cfg, tile_capacity=k,
                                           two_tier_split=0))
        proj = project(gaussians, cam, c)
        return composite_tiled(proj, cam.width, cam.height, c)["rgb"]

    with torch.no_grad():
        refs = [render(cam, k_full) for cam in cameras]
        k = 128
        while k < k_full:
            ok = True
            for cam, ref in zip(cameras, refs):
                mse = float(((render(cam, k) - ref) ** 2).mean())
                psnr = 10.0 * math.log10(1.0 / max(mse, 1e-12))
                if psnr < gate_db:
                    ok = False
                    break
            if ok:
                return k
            k *= 2
    return k_full


def mesh_demand(mesh_steps: Iterable[List[tuple]], cameras: Sequence[Camera],
                cfg: MeshRasterConfig = MeshRasterConfig()) -> Dict[str, int]:
    """The triangle BinStats of rasterize_mesh at cfg over every (step,
    camera, link) of mesh_steps (per step, a list of posed (vertices,
    faces, colors), as scenegen/rollout.py's rollout_meshes yields them):
    the largest per-tile triangle count, and the overflowed tiles and
    truncated triangles summed."""
    worst = overflowed = truncated = 0
    with torch.no_grad():
        for meshes in mesh_steps:
            for cam in cameras:
                for v, f, c in meshes:
                    st = rasterize_mesh(v, f, cam, vertex_colors=c,
                                        cfg=cfg)["stats"]
                    worst = max(worst, int(st.max_tile_count))
                    overflowed += int(st.overflowed_tiles)
                    truncated += int(st.truncated_gaussians)
    return {"max_tile_count": worst, "overflowed_tiles": overflowed,
            "truncated_triangles": truncated}


def mesh_tile_capacity(max_tile_count: int) -> int:
    """The smallest power of two that holds max_tile_count triangles: a
    mesh tile capacity at which no measured tile overflows."""
    return 1 << max(0, max_tile_count - 1).bit_length()
