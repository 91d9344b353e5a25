"""The Gaussian-only rollout frame: four 640x480 cameras of 200k
Gaussians, decomposed, drawn three ways, and gated by capacity.

    python -m robosimgs_tpu_torch.tools.profile_rollout [--iters 20]
        [--variants 'name,k=..,m=..,bbox=..,split=..,frac=..;...']
        [--gate 1] [--k-lossless 8192] [--n 200000] [--width 640]
        [--height 480] [--device cuda]

A port of the JAX package's scripts/profile_rollout.py on the rollout
workload's Gaussians and cameras (tools/workloads.py::rollout_scene:
200k random Gaussians, SH 2, extent 1.5, torch.Generator seed 2; four
cameras at look_at([3.0 + 0.1 i, 0.4, 1.0] -> 0, 60 deg)), drawn with
no mesh. The script's environment knobs are flags with its defaults
(RSGS_PROF_ITERS -> --iters, RSGS_ROLLOUT_VARIANTS -> --variants,
RSGS_ROLLOUT_GATE -> --gate, RSGS_ROLLOUT_K_LOSSLESS -> --k-lossless);
--n, --width and --height shrink the scene for a run on the CPU.

  1. Stages on camera 0 at the script's r4 config (K 1,024, M 12):
     project, project + bin_and_gather_packed, the forward kernel with
     no depth limit (`pallas_fwd_ms`, the script's key), and camera 0's
     BinStats.
  2. For each config variant (`r4_single_K1024` always, then the
     --variants spec's), a frame three ways: one camera
     (`one_cam_ms`), four composite_tiled calls (`seq4_ms`), and
     composite_tiled_batch over stack_projected, one forward launch for
     the 4 x T tiles (`batched4_ms`); each by the device's timer and by
     the host's wall clock, twice, in the order events, wall, wall,
     events (`{strategy}_runs_ms`; `_ms` and `_wall_ms` are the means of
     each timer's two readings), with the forward launches of one frame
     and the device's idle share over one profiled frame.
  3. The K gate on camera 0 (--gate 1): each candidate K (2,048, 1,024,
     512) at M 64 over an 84-tile bbox against the lossless K (8,192,
     tile_chunk 512) at the same M and bbox (`gate_K{k}_dB`), and the
     r4 config against it (`r4_lossy_dB`), with every render's
     truncated Gaussians. A candidate truncating at M 64 would measure
     M's truncation, not K's overflow.

`mkcfg` keeps the script's rule that tile_chunk divides K (512 where
512 divides K, else one chunk). Prints `RESULT {json}` with the
script's keys (times unrounded, in ms) and the device and timer. Times
are CUDA events on a card and the host's clock on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from robosimgs_tpu_torch.render.binning import bin_and_gather_packed
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.kernels import composite_fwd
from robosimgs_tpu_torch.render.project import project
from robosimgs_tpu_torch.render.tiled import (composite_tiled,
                                              composite_tiled_batch,
                                              stack_projected)
from robosimgs_tpu_torch.render.tiles import num_tiles
from robosimgs_tpu_torch.tools import workloads
from robosimgs_tpu_torch.tools.k_equiv import device_name
from robosimgs_tpu_torch.train.losses import psnr
from robosimgs_tpu_torch.utils.profiling import device_rows

ITERS = 20
K_LOSSLESS = 8192
GATE_KS = (2048, 1024, 512)
# the lossless M and bbox: at or above the rollout draws' max survivor
# and bbox covers (tools/staged_cover_stats.py --workload rollout)
GATE_M, GATE_BBOX = 64, 84


def mkcfg(k: int, m: int = 12, bbox: int = 0, split: int = 0,
          frac: float = 0.0, chunk: int | None = None) -> RenderConfig:
    """The script's nested mkcfg: K, M, bbox and two tiers, tile_chunk
    512 where it divides K (else one chunk) unless given."""
    if chunk is None:
        chunk = 512 if k % 512 == 0 else 0
    return RenderConfig(tile_capacity=k, tile_chunk=chunk,
                        max_tiles_per_gaussian=m,
                        bbox_tiles_per_gaussian=bbox, two_tier_split=split,
                        two_tier_spill_frac=frac)


def parse_variants(spec: str) -> dict:
    """{name: RenderConfig}: `r4_single_K1024` (mkcfg(1024)), then each
    'name,k=..,m=..,bbox=..,split=..,frac=..' of the ';'-separated spec
    (the script's RSGS_ROLLOUT_VARIANTS; an absent key takes mkcfg's
    default, an absent k 1,024)."""
    variants = {"r4_single_K1024": mkcfg(1024)}
    for item in spec.split(";"):
        if not item:
            continue
        name, *kv = item.split(",")
        kw = dict(x.split("=") for x in kv)
        variants[name] = mkcfg(int(kw.get("k", 1024)), m=int(kw.get("m", 12)),
                               bbox=int(kw.get("bbox", 0)),
                               split=int(kw.get("split", 0)),
                               frac=float(kw.get("frac", 0.0)))
    return variants


def render(g, cam, cfg: RenderConfig):
    """(rgb, BinStats) of composite_tiled(project(g, cam, cfg))."""
    with torch.no_grad():
        out = composite_tiled(project(g, cam, cfg), cam.width, cam.height,
                              cfg, return_stats=True)
    return out["rgb"], out["stats"]


def gate(g, cam, cands=tuple((k, None) for k in GATE_KS),
         ref=(K_LOSSLESS, 512), m: int = GATE_M, bbox: int = GATE_BBOX,
         lossy: RenderConfig | None = None) -> dict:
    """Each candidate (K, tile_chunk; None: mkcfg's rule) at M m over a
    bbox-tile enumeration against the reference (K, tile_chunk) at the
    same M and bbox, on one camera: {"gate_K{k}_dB": PSNR}, with
    `lossy` (a config) "r4_lossy_dB"; "truncated": every render's
    truncated Gaussians by name; "rgb": every render by name (not
    serialised by the CLI)."""
    ref_name = f"K{ref[0]}"
    rgb, st = render(g, cam, mkcfg(ref[0], m, bbox, chunk=ref[1]))
    out = {"truncated": {ref_name: int(st.truncated_gaussians)},
           "rgb": {ref_name: rgb}}
    runs = [(f"K{k}", f"gate_K{k}_dB", mkcfg(k, m, bbox, chunk=chunk))
            for k, chunk in cands]
    if lossy is not None:
        runs.append(("r4", "r4_lossy_dB", lossy))
    for name, key, cfg in runs:
        img, st = render(g, cam, cfg)
        out[key] = float(psnr(img, rgb))
        out["truncated"][name] = int(st.truncated_gaussians)
        out["rgb"][name] = img
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def wall_ms(fn, reps: int, dev) -> float:
    """Host wall ms a call of fn over reps calls after one, ending in a
    device sync."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def idle_share(fn, dev):
    """1 - (device busy / host wall) over one profiled call of fn (the
    device's self time summed over the trace); None off a card."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile
    fn()
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in device_rows(prof)) / 1e3
    return 1.0 - busy / wall


def launches_of(fn) -> int:
    """Forward kernel launches in one call of fn (0 on the CPU, where
    the plain version runs)."""
    before = composite_fwd.launches
    fn()
    return composite_fwd.launches - before


def frame_fns(g, cams, cfg: RenderConfig) -> dict:
    """{strategy: fn} of one frame's rgb: one camera, four sequential
    composite_tiled calls, one composite_tiled_batch."""
    W, H = cams[0].width, cams[0].height

    def one():
        return composite_tiled(project(g, cams[0], cfg), W, H, cfg)["rgb"]

    def seq4():
        return [composite_tiled(project(g, c, cfg), W, H, cfg)["rgb"]
                for c in cams]

    def batched4():
        projs = stack_projected([project(g, c, cfg) for c in cams])
        return composite_tiled_batch(projs, W, H, cfg)["rgb"]

    return {"one_cam": one, "seq4": seq4, "batched4": batched4}


def profile_rollout(g, cams, variants: dict, iters: int = ITERS,
                    run_gate: bool = True, k_lossless: int = K_LOSSLESS,
                    log=print) -> dict:
    """Steps 1-3 of the module docstring on (g, cams); variants as
    parse_variants gives them. Returns the RESULT dict, with "gate":
    gate()'s return (its "rgb" included) when run_gate."""
    dev = g.device
    timer, timer_name = workloads.timer(dev)
    cam = cams[0]
    W, H = cam.width, cam.height
    tiles_x, tiles_y = num_tiles(W, H, 16)
    cfg_r4 = variants["r4_single_K1024"]
    res = {"n": g.capacity, "T": tiles_x * tiles_y, "iters": iters,
           "device": device_name(dev), "timer": timer_name}
    with torch.no_grad():
        res["project_ms"] = timer(lambda: project(g, cam, cfg_r4), reps=iters)
        res["project_bin_ms"] = timer(lambda: bin_and_gather_packed(
            project(g, cam, cfg_r4), W, H, cfg_r4), reps=iters)
        geom, feat, counts, st = bin_and_gather_packed(
            project(g, cam, cfg_r4), W, H, cfg_r4)
        res["cam0_stats"] = {
            "max_count": int(st.max_tile_count),
            "trunc": int(st.truncated_gaussians),
            "overflow": int(st.overflowed_tiles),
            "pairs": int(st.total_pairs)}
        log("cam0 stats: " + " ".join(f"{k}={v}" for k, v in
                                      res["cam0_stats"].items()))
        res["pallas_fwd_ms"] = timer(lambda: composite_fwd(
            geom, feat, counts, None, tiles_x=tiles_x, cfg=cfg_r4,
            has_dlim=False), reps=iters)
        del geom, feat, counts
        log(f"project {res['project_ms']:.4f} ms, project+bin "
            f"{res['project_bin_ms']:.4f} ms, forward "
            f"{res['pallas_fwd_ms']:.4f} ms ({timer_name})")

        for name, cfg in variants.items():
            row = {}
            for strat, fn in frame_fns(g, cams, cfg).items():
                # each timer before and after the other: events, wall,
                # wall, events; the mean of each timer's two readings
                runs = [timer(fn, reps=iters), wall_ms(fn, iters, dev)]
                runs += [wall_ms(fn, iters, dev), timer(fn, reps=iters)]
                row[f"{strat}_ms"] = (runs[0] + runs[3]) / 2
                row[f"{strat}_wall_ms"] = (runs[1] + runs[2]) / 2
                row[f"{strat}_runs_ms"] = runs
                row[f"{strat}_launches"] = launches_of(fn)
                row[f"{strat}_idle"] = idle_share(fn, dev)
            res[name] = row
            log(f"{name}: 1cam={row['one_cam_ms']:.4f} seq4="
                f"{row['seq4_ms']:.4f} batched4={row['batched4_ms']:.4f} "
                f"ms ({timer_name}); host wall {row['one_cam_wall_ms']:.4f} "
                f"/ {row['seq4_wall_ms']:.4f} / {row['batched4_wall_ms']:.4f}"
                f" ms; launches a frame {row['seq4_launches']} / "
                f"{row['batched4_launches']}; idle {row['seq4_idle']} / "
                f"{row['batched4_idle']}")

    if run_gate:
        gt = gate(g, cam, ref=(k_lossless, 512), lossy=cfg_r4)
        for k in GATE_KS:
            res[f"gate_K{k}_dB"] = gt[f"gate_K{k}_dB"]
            log(f"K={k} (m={GATE_M}) vs K={k_lossless}: "
                f"{gt[f'gate_K{k}_dB']:.2f} dB")
        res["r4_lossy_dB"] = gt["r4_lossy_dB"]
        res["gate_truncated"] = gt["truncated"]
        log(f"r4 lossy (M=12,K=1024) vs lossless: {gt['r4_lossy_dB']:.2f} "
            f"dB; truncated {gt['truncated']}")
        res["gate"] = gt
    return res


def scene(dev, n: int, width: int, height: int):
    """(Gaussians, [Camera] x 4, the rollout RenderConfig) of the rollout
    workload at n Gaussians, the cameras at width x height."""
    g, cams, cfg = workloads.rollout_scene(dev, n=n)
    if (width, height) != (cams[0].width, cams[0].height):
        cams = [c.resized(width, height) for c in cams]
    return g, cams, cfg


def add_scene_args(ap) -> None:
    ap.add_argument("--n", type=int, default=workloads.ROLLOUT_GAUSSIANS)
    ap.add_argument("--width", type=int,
                    default=workloads.ROLLOUT_CAMERAS[0]["width"])
    ap.add_argument("--height", type=int,
                    default=workloads.ROLLOUT_CAMERAS[0]["height"])
    ap.add_argument("--device", default="cuda")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--variants", default="")
    ap.add_argument("--gate", type=int, default=1, choices=(0, 1))
    ap.add_argument("--k-lossless", type=int, default=K_LOSSLESS)
    add_scene_args(ap)
    args = ap.parse_args(argv)
    dev = workloads.open_device(args.device, "profile_rollout")
    if dev is None:
        return 1
    g, cams, _ = scene(dev, args.n, args.width, args.height)
    print(f"device={device_name(dev)}", flush=True)
    res = profile_rollout(g, cams, parse_variants(args.variants), args.iters,
                          bool(args.gate), args.k_lossless,
                          log=lambda s: print(s, flush=True))
    res.pop("gate", None)
    print("RESULT " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
