"""Time the backward's split kernel (composite_bwd on tiles over 16x16)
over the number of blocks a tile, for this checkout and other copies of
the package, on one card.

    python -m robosimgs_tpu_torch.tools.split_sweep [OTHER ...] \
        [--splits 1 2 4 8] [--out FILE]

Each OTHER is the root of another copy of the package, as for
tools/kernel_ab.py: a copy with one constexpr of csrc/composite_bwd.cu
changed (LARGE_THREADS), or an earlier commit unpacked by `git archive`.
On the bench view on 32x32 tiles at the capacities recommend_capacities
gives it, and on the feasibility workload's 512x512 view
(tools/workloads.py), it times each copy's composite_bwd (CUDA events,
mean of 30 launches) at every --splits value (its `bwd_splits` replaced
for the call; a copy without one, whose kernel takes one block a tile,
once at its own launch), holds each result against this checkout's
plain version (largest |difference|), and times each copy's launch with
every tile but the deepest given nblk = 0 (that tile's chain alone). The
results also go to --out as JSON. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

from robosimgs_tpu_torch.render import _build, kernels
from robosimgs_tpu_torch.render.autotune import recommend_capacities
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.tools.kernel_ab import load_other, view_blocks
from robosimgs_tpu_torch.tools.workloads import (bench_scene,
                                                 feasibility_scene, time_ms)


def views(dev):
    """Yields (tag, args of composite_bwd, kw): the forward kernel's
    residuals and a seeded cotangent on the two 32x32-tile views."""
    g, cam, _ = bench_scene(dev)
    cfg32 = recommend_capacities(g, [cam], base=RenderConfig(tile_size=32))
    blocks = [("bench 32x32 tiles", view_blocks(g, cam, cfg32))]
    del g
    blocks.append(("feasibility 512x512",
                   view_blocks(*feasibility_scene(dev))))
    for tag, (geom, feat, counts, kw) in blocks:
        fwd = kernels.composite_fwd(geom, feat, counts, None, **kw)
        gout = torch.randn(fwd[0].shape, generator=torch.Generator()
                           .manual_seed(32)).to(dev)
        yield tag, (geom, feat, counts, None, gout, *fwd[1:]), kw


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*", type=Path, metavar="OTHER")
    ap.add_argument("--splits", nargs="+", type=int, default=[1, 2, 4, 8])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("split_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    builds = {"this": (kernels, _build)}
    builds.update((str(root), load_other(root)) for root in args.others)
    result = {"card": smi, "torch": torch.__version__, "ptxas": {},
              "shapes": {}}
    for tag, (_, build) in builds.items():
        result["ptxas"][tag] = build.build_all(["composite_bwd"])[
            "composite_bwd"].ptxas or "(already built)"
    with torch.no_grad():
        for tag, bwd_args, kw in views(dev):
            want = kernels.composite_bwd_plain(*bwd_args, **kw)
            nblk = bwd_args[6]
            deepest = int(nblk.argmax())
            alone = torch.where(torch.arange(nblk.shape[0], device=dev)
                                == deepest, nblk, 0).to(torch.int32)
            alone_args = bwd_args[:6] + (alone,) + bwd_args[7:]
            rec = {"T": int(nblk.shape[0]), "K": int(bwd_args[0].shape[2]),
                   "nblk_max": int(nblk.max())}
            for name, (k, _) in builds.items():
                planner = getattr(k, "bwd_splits", None)
                runs = {}
                for s in (args.splits if planner else [None]):
                    if planner:
                        k.bwd_splits = lambda *a, s=s: s
                    try:
                        got = k.composite_bwd(*bwd_args, **kw)
                        err = max(float((a - b).abs().max())
                                  for a, b in zip(got, want))
                        ms = time_ms(lambda: k.composite_bwd(*bwd_args, **kw),
                                     reps=30)
                    finally:
                        if planner:
                            k.bwd_splits = planner
                    runs["own" if s is None else str(s)] = {
                        "ms": ms, "max_abs_err": err}
                rec[name] = {"splits": runs, "deepest_tile_alone_ms": time_ms(
                    lambda: k.composite_bwd(*alone_args, **kw), reps=30)}
            result["shapes"][tag] = rec
            print(f"{tag}: {json.dumps(rec)}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
