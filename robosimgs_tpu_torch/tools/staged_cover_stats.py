"""Tile-cover statistics of a draw: what sizes M, the bbox, K and the
two-tier spill so that nothing is truncated.

    python -m robosimgs_tpu_torch.tools.staged_cover_stats
        [--workload staged|rollout] [--n N] [--res 512] [--device cuda]
        [--out stats.json]

A port of the JAX package's scripts/staged_cover_stats.py (its
STAGED_N, STAGED_RES and STAGED_STATS_OUT are --n, --res and --out).
On one camera (`cover_stats`):

  * the largest bbox cover and the survivor cover after the exact
    ellipse-tile cull, from tools/staged_lossless.py::draw_covers (the
    staged config's 16-px tiles), and the survivor cover's percentiles
    (50 / 90 / 99 / 99.9 / 100);
  * the six cheapest lossless two-tier options: a split s keeps s tiles
    for every Gaussian and a spill tier of every Gaussian whose cover
    exceeds s (rows rounded up to 128, at most n); slots = s n + rows
    (M - s) at M = the largest survivor cover;
  * the true per-tile demand: each tile's (Gaussian, tile) pairs after
    the cull, counted over chunks of 100,000 Gaussians (the binner's
    `_bbox_slots` and `_cull_keep`). It must sum to the total pairs
    (the survivor covers' sum), and its largest must equal
    staged_lossless.measure_draw's, from a lossless binning: the tool
    raises if either does not hold.

--workload staged (default) is the 1M-Gaussian 512x512 staged draw
(tools/workloads.py::staged_scene, torch.Generator seed 1); rollout is
the rollout draw (rollout_scene: 200k Gaussians, seed 2) on each of its
four 640x480 cameras, with the maxima over them. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from robosimgs_tpu_torch.render.binning import _bbox_slots, _cull_keep
from robosimgs_tpu_torch.render.tiles import num_tiles
from robosimgs_tpu_torch.tools import workloads
from robosimgs_tpu_torch.tools.k_equiv import device_name
from robosimgs_tpu_torch.tools.staged_lossless import (draw_covers,
                                                       measure_draw,
                                                       staged_config)

CHUNK = 100_000
PERCENTILES = (50, 90, 99, 99.9, 100)


def two_tier_options(cover: np.ndarray, max_surv: int, top: int = 6):
    """[(slots, split, spill rows)] of the `top` cheapest lossless
    two-tier splits s in 2, 4, ... < max_surv, cheapest first."""
    n = len(cover)
    over = n - np.cumsum(np.bincount(cover, minlength=max_surv + 1))
    options = []
    for s in range(2, max_surv, 2):
        rows = min(n, (int(over[s]) + 127) // 128 * 128)
        options.append((s * n + rows * (max_surv - s), s, rows))
    return sorted(options)[:top]


def tile_demand(covers: dict, width: int, height: int, max_bbox: int,
                chunk: int = CHUNK) -> torch.Tensor:
    """(T,) int64: each tile's pairs after the exact cull, counted over
    chunks of Gaussians so that (chunk, max_bbox) bounds the memory."""
    cfg = staged_config()
    proj = covers["proj"]
    tiles_x, tiles_y = num_tiles(width, height, cfg.tile_size)
    T = tiles_x * tiles_y
    tx0, ty0, tx1, ty1 = covers["bbox"]
    zero = torch.zeros_like(proj.opacities)
    cop = torch.stack([proj.conics[:, 0], proj.conics[:, 1],
                       proj.conics[:, 2],
                       torch.where(proj.valid, proj.opacities, zero)], dim=1)
    valid = proj.valid & (proj.radii > 0)
    counts = torch.zeros(T + 1, dtype=torch.int64, device=proj.means2d.device)
    with torch.no_grad():
        for i in range(0, valid.shape[0], chunk):
            sl = slice(i, i + chunk)
            tid, row, col, in_bbox, _ = _bbox_slots(
                tx0[sl], ty0[sl], tx1[sl], ty1[sl], max_bbox, tiles_x)
            ok = in_bbox & valid[sl, None] & _cull_keep(
                proj.means2d[sl], cop[sl], tx0[sl], ty0[sl], col, row,
                cfg.tile_size, cfg.alpha_min)
            counts += torch.bincount(torch.where(ok, tid, T).reshape(-1),
                                     minlength=T + 1)
    return counts[:T]


def cover_stats(g, cam, chunk: int = CHUNK, log=None) -> dict:
    """The module docstring's statistics of g on one camera, as the JAX
    script's JSON (with the percentiles, the per-tile demand's mean and
    99th percentile, the Gaussians past the staged split of 12 and the
    device added). Raises AssertionError if the per-tile demand does
    not sum to the total pairs or its largest differs from the lossless
    binning's."""
    log = log or (lambda line: None)
    n, W, H = g.capacity, cam.width, cam.height
    covers = draw_covers(g, cam)
    draw = measure_draw(g, cam, covers=covers)
    max_bbox, max_surv = draw["max_bbox_cover"], draw["max_survivor_cover"]
    cover = covers["survivor_cover"].cpu().numpy().astype(np.int64)
    total = int(cover.sum())
    tiles_x, tiles_y = num_tiles(W, H, 16)
    log(f"n={n} {W}x{H} T={tiles_x * tiles_y} valid="
        f"{int(covers['proj'].valid.sum())}; max bbox cover {max_bbox}, "
        f"max survivor cover {max_surv}, total true pairs {total}")
    pct = {str(p): int(np.percentile(cover, p)) for p in PERCENTILES}
    log(f"cover percentiles: {pct}")
    options = two_tier_options(cover, max_surv)
    for slots, s, rows in options:
        log(f"  split={s:3d} rows={rows:8d} frac={rows / n:.4f} "
            f"slots={slots / 1e6:.2f}M (single-tier {max_surv * n / 1e6:.1f}M)")
    per_tile = tile_demand(covers, W, H, max_bbox, chunk).cpu().numpy()
    log(f"per-tile demand: max={int(per_tile.max())} mean="
        f"{per_tile.mean():.0f} p99={int(np.percentile(per_tile, 99))} "
        f"sum={int(per_tile.sum())} (== total pairs: "
        f"{int(per_tile.sum()) == total})")
    if int(per_tile.sum()) != total or total != draw["total_pairs"]:
        raise AssertionError(
            f"per-tile demand sums to {int(per_tile.sum())}, the survivor "
            f"covers to {total}, the binning's pairs to {draw['total_pairs']}")
    if int(per_tile.max()) != draw["max_tile_demand"]:
        raise AssertionError(
            f"largest per-tile demand {int(per_tile.max())}, the binning's "
            f"{draw['max_tile_demand']}")
    return {"n": n, "res": [W, H] if W != H else W, "T": tiles_x * tiles_y,
            "max_bbox_cover": max_bbox, "max_survivor_cover": max_surv,
            "total_true_pairs": total, "max_tile_demand": int(per_tile.max()),
            "two_tier_lossless": [
                {"split": s, "rows": r, "frac": r / n, "slots": sl}
                for sl, s, r in options],
            "cover_percentiles": pct,
            "mean_tile_demand": float(per_tile.mean()),
            "p99_tile_demand": int(np.percentile(per_tile, 99)),
            "rows_over_split": draw["rows_over_split"],
            "split": draw["split"], "device": device_name(g.device)}


def rollout_cover_stats(g, cams, chunk: int = CHUNK, log=None) -> dict:
    """cover_stats on each camera ("views") and the maxima over them."""
    views = [cover_stats(g, c, chunk, log) for c in cams]
    return {"workload": "rollout", "n": g.capacity, "views": views,
            **{k: max(v[k] for v in views)
               for k in ("max_bbox_cover", "max_survivor_cover",
                         "max_tile_demand", "rows_over_split")},
            "device": device_name(g.device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=("staged", "rollout"),
                    default="staged")
    ap.add_argument("--n", type=int, default=None,
                    help="Gaussians (default: the workload's)")
    ap.add_argument("--res", type=int, default=workloads.STAGED_RES,
                    help="the staged camera's side")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    dev = workloads.open_device(args.device, "staged_cover_stats")
    if dev is None:
        return 1

    def log(line):
        print(line, flush=True)

    if args.workload == "staged":
        g, cam = workloads.staged_scene(
            dev, n=args.n or workloads.STAGED_GAUSSIANS, res=args.res)
        res = {"workload": "staged", **cover_stats(g, cam, log=log)}
    else:
        g, cams, _ = workloads.rollout_scene(
            dev, n=args.n or workloads.ROLLOUT_GAUSSIANS)
        res = rollout_cover_stats(g, cams, log=log)
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
