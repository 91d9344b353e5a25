"""Time the forward kernel's walks of a cluster tile's slots against each
other over launch sizes, on one card.

    python -m robosimgs_tpu_torch.tools.fwd_grains [--reps N] [--out FILE]

The forward on tiles over 16x16 walks each batch's slots in one of three
ways (render/kernels.py::composite_fwd's `skip`): every slot ("none"),
the slots some pixel of each warp may keep ("warp"), or those some pixel
of each block's band may keep ("band"). `fwd_skip_grain` picks one from
the launch's size. This tool times all three at launch sizes on both
sides of that switch, on two workloads (tools/workloads.py):

- the bench view on 32x32 tiles at the capacity recommend_capacities
  gives it (T = 64 tiles), as a batch of 1 to 4 copies of the view
  (T = 64, 128, 192, 256; `n_tiles_per_image` 64);
- the feasibility workload's 512x512 view on 32x32 tiles, cut to its
  first R rows of tiles (T = 16 R for R = 4, 6, ..., 16), which keeps
  every tile's pixel coordinates.

For each size it checks that the three walks give the same bits
(tools/quadrants.py::forward_diffs), and prints each walk's time (CUDA
events, the mean of --reps launches, taken twice in the order none,
warp, band, band, warp, none), the share of the processed (pixel, slot)
pairs each skipped (the kernel's own count), the fastest walk and the one
fwd_skip_grain picks. The results also go to --out as JSON. Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

from robosimgs_tpu_torch.render.autotune import recommend_capacities
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.kernels import composite_fwd, fwd_skip_grain
from robosimgs_tpu_torch.tools.kernel_ab import view_blocks
from robosimgs_tpu_torch.tools.quadrants import forward_diffs
from robosimgs_tpu_torch.tools.workloads import (bench_scene,
                                                 feasibility_scene, time_ms)

WALKS = ("none", "warp", "band")


def launches(dev):
    """Yields (tag, geom, feat, counts, kw) of each launch size."""
    g, cam, _ = bench_scene(dev)
    cfg32 = recommend_capacities(g, [cam], base=RenderConfig(tile_size=32))
    geom, feat, counts, kw = view_blocks(g, cam, cfg32)
    del g
    T = geom.shape[0]
    for c in range(1, 5):
        yield (f"bench 32x32 x{c}", geom.repeat(c, 1, 1), feat.repeat(c, 1, 1),
               counts.repeat(c), dict(kw, n_tiles_per_image=T))
    del geom, feat, counts
    geom, feat, counts, kw = view_blocks(*feasibility_scene(dev))
    tiles_x = kw["tiles_x"]
    for rows in range(4, geom.shape[0] // tiles_x + 1, 2):
        n = rows * tiles_x
        yield (f"feasibility {rows} tile rows", geom[:n].contiguous(),
               feat[:n].contiguous(), counts[:n].contiguous(), kw)


def measure(geom, feat, counts, kw, reps: int) -> dict:
    """Each walk's times, skipped share and largest difference from "none"."""
    outs, skipped = {}, {}
    for w in WALKS:
        pairs = torch.zeros(2, dtype=torch.int64, device=geom.device)
        outs[w] = composite_fwd(geom, feat, counts, None, **kw, skip=w,
                                pairs=pairs)
        walked, processed = pairs.tolist()
        skipped[w] = (processed - walked) / processed if processed else 0.0
    diffs = {w: forward_diffs(outs[w], outs["none"]) for w in WALKS[1:]}
    ms = {w: [] for w in WALKS}
    for w in WALKS + WALKS[::-1]:
        ms[w].append(time_ms(lambda w=w: composite_fwd(
            geom, feat, counts, None, **kw, skip=w), reps))
    n_sms = torch.cuda.get_device_properties(geom.device).multi_processor_count
    return dict(T=geom.shape[0], K=geom.shape[2], ms=ms, skipped=skipped,
                diffs=diffs,
                fastest=min(WALKS, key=lambda w: sum(ms[w])),
                picked=fwd_skip_grain(geom.shape[0], kw["cfg"].tile_size,
                                      n_sms))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fwd_grains: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    result = {"card": smi, "torch": torch.__version__, "sizes": {}}
    bad = []
    for tag, geom, feat, counts, kw in launches(dev):
        with torch.no_grad():
            r = measure(geom, feat, counts, kw, args.reps)
        result["sizes"][tag] = r
        times = "; ".join(
            f"{w} {', '.join(f'{t:.4f}' for t in r['ms'][w])} ms "
            f"(skips {r['skipped'][w]:.4f})" for w in WALKS)
        print(f"{tag}: T {r['T']}, K {r['K']}: {times}; fastest "
              f"{r['fastest']}, picked {r['picked']}", flush=True)
        for w, d in r["diffs"].items():
            if any(d.values()):
                bad.append(f"{tag} {w}: {d}")
        del geom, feat, counts
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    if bad:
        print("walks differ: " + "; ".join(bad), file=sys.stderr)
        return 1
    print("every walk 0.0 from walking every slot", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
