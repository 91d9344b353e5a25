"""Hold this checkout's compositing kernels against other checkouts' kernels,
on one card.

    python -m robosimgs_tpu_torch.tools.kernel_ab OTHER [OTHER ...] \
        [--out FILE]

Each OTHER is the root of another copy of the package (a directory that
holds robosimgs_tpu_torch/): an earlier commit unpacked by `git archive`,
or a copy with one constexpr of csrc/ changed. Its kernels are built by
its own render/_build.py (into OTHER/build/kernels/) and called through
its own composite_fwd and composite_bwd, so an older interface needs
nothing here: the backward is given whatever residuals its forward
returned after `out`.

On the bench view, the same scene's two 640x480 orbit views, the bench
view on 32x32 tiles at the capacities recommend_capacities gives it, and
the feasibility workload's 512x512 view on 32x32 tiles
(tools/workloads.py) it prints each build's ptxas report, the largest
difference of out, log_t_final, nblk, dgeom and dfeat from this
checkout's (the sign of a zero is no difference), and each build's
kernel times by CUDA events (mean of 200 launches), taken twice, in the
order this, others, others reversed, this. The results also go to --out
as JSON. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from robosimgs_tpu_torch.render import _build, kernels
from robosimgs_tpu_torch.render.autotune import recommend_capacities
from robosimgs_tpu_torch.render.binning import bin_and_gather_packed
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.project import project
from robosimgs_tpu_torch.render.tiles import num_tiles
from robosimgs_tpu_torch.tools.workloads import (bench_scene,
                                                 feasibility_scene,
                                                 orbit_views, time_ms)

PKG = "robosimgs_tpu_torch"
OUTPUTS = ("out", "log_t_final", "nblk", "dgeom", "dfeat")


def _package_modules() -> dict:
    return {k: m for k, m in sys.modules.items()
            if k == PKG or k.startswith(PKG + ".")}


def load_other(root: Path):
    """(render.kernels, render._build) of the package under root, imported
    beside this one, whose modules stay in sys.modules."""
    ours = _package_modules()
    for k in ours:
        del sys.modules[k]
    sys.path.insert(0, str(root))
    importlib.invalidate_caches()
    try:
        other = importlib.import_module(f"{PKG}.render.kernels")
        build = importlib.import_module(f"{PKG}.render._build")
    finally:
        sys.path.remove(str(root))
        for k in _package_modules():
            del sys.modules[k]
        sys.modules.update(ours)
    if not Path(other.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"no {PKG} under {root}")
    return other, build


def max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.dtype != torch.float32:
        return float((a.long() - b.long()).abs().max())
    return float(torch.nan_to_num((a - b).abs(), nan=float("inf")).max())


def view_blocks(g, c, cf):
    geom, feat, counts, _ = bin_and_gather_packed(
        project(g, c, cf), c.width, c.height, cf)
    kw = dict(tiles_x=num_tiles(c.width, c.height, cf.tile_size)[0],
              cfg=cf, has_dlim=False)
    return geom, feat, counts, kw


def views(dev):
    """Yields (tag, geom, feat, counts, kw) of the bench view, the orbit
    views, the bench view on 32x32 tiles and the feasibility view (made
    one after the other: the 3M scene is freed before the next)."""
    g, cam, cfg = bench_scene(dev)
    for tag, (c, cf) in [("bench 256x256", (cam, cfg))] + [
            (f"orbit {i} 640x480", v) for i, v in enumerate(orbit_views(g, dev))]:
        yield (tag, *view_blocks(g, c, cf))
    cfg32 = recommend_capacities(g, [cam], base=RenderConfig(tile_size=32))
    yield ("bench 32x32 tiles", *view_blocks(g, cam, cfg32))
    del g
    yield ("feasibility 512x512", *view_blocks(*feasibility_scene(dev)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="+", type=Path, metavar="OTHER")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
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
        built = build.build_all(["composite_fwd", "composite_bwd"])
        result["ptxas"][tag] = {n: b.ptxas or "(already built)"
                                for n, b in built.items()}
        print(f"ptxas {tag}: {json.dumps(result['ptxas'][tag], indent=1)}",
              flush=True)

    order = list(builds) + list(builds)[::-1]
    with torch.no_grad():
        for tag, geom, feat, counts, kw in views(dev):
            gout = torch.randn((geom.shape[0], 8, kw["cfg"].tile_size ** 2),
                               generator=torch.Generator().manual_seed(3)
                               ).to(dev)
            runs = {}
            for name, (k, _) in builds.items():
                res = k.composite_fwd(geom, feat, counts, None, **kw)
                runs[name] = (res, k.composite_bwd(geom, feat, counts, None,
                                                   gout, *res[1:], **kw))
            torch.cuda.synchronize()
            ours = runs["this"][0][:3] + runs["this"][1]
            rec = {"T": geom.shape[0], "K": geom.shape[2]}
            for name in builds:
                res, d = runs[name]
                rec[name] = {"max_diff": {n: max_diff(a, b) for n, a, b in
                                          zip(OUTPUTS, res[:3] + d, ours)},
                             "fwd_ms": [], "bwd_ms": []}
            for name in order:
                k, res = builds[name][0], runs[name][0]
                rec[name]["fwd_ms"].append(time_ms(
                    lambda: k.composite_fwd(geom, feat, counts, None, **kw),
                    reps=200, warmup=5))
                rec[name]["bwd_ms"].append(time_ms(
                    lambda: k.composite_bwd(geom, feat, counts, None, gout,
                                            *res[1:], **kw),
                    reps=200, warmup=5))
            result["shapes"][tag] = rec
            print(f"{tag}: {json.dumps(rec)}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
