"""The lossless 1M-Gaussian 512x512 staged config: its draw's covers,
the capacity gates against the lossless K, the gradient check and the
train step's time.

    python -m robosimgs_tpu_torch.tools.staged_lossless [--n 1000000]
        [--res 512] [--iters 10] [--k-cands 2048 1024] [--k-staged 384]
        [--device cuda]

A port of the JAX package's scripts/staged_lossless.py on the staged
workload (tools/workloads.py: staged_scene, staged_config). The JAX
script's constants, M 24 over a 28-tile bbox and the lossless K 22,016,
were measured on its own jax.random draw; this draw is another, so:

  1. It measures the draw (`measure_draw`): the largest bbox cover
     (`tile_bbox`), the largest survivor cover after the exact cull
     (`per_gaussian_cover`), the largest per-tile demand and the pairs
     (`BinStats` of a lossless single-tier binning) and the Gaussians
     whose survivor cover exceeds the two-tier split of 12.
  2. The train steps of step 5 move the Gaussians, and a bbox that
     crosses one more tile boundary grows by a whole row or column of
     tiles (on an H100 the 1M draw's largest, 25, became 30 after two
     steps). So it measures the same on every state of each timed run
     too (`measure_steps`): the run goes once first, from the same state
     at a wide M and bbox, so it truncates nothing and renders the pairs
     the timed run renders. It keeps the JAX constants where the maxima
     over the draw and those states fit them, else sizes them by the
     same rule (M >= max survivor cover, bbox >= max bbox cover,
     lossless K >= the draw's demand rounded up to 512), and says why.
     The spill fraction comes from the largest count of Gaussians past
     the split, so the spill tier holds every one of them.
  3. It renders at the lossless K, at K 2,048 and 1,024 (one tier) and
     at bench.py's staged K 384 with the two-tier split 12, asserts zero
     truncated Gaussians on each, and gates each against the lossless
     render at >= 60 dB.
  4. One gradient of the photometric loss at K 384 two-tier against one
     at the lossless K: the largest |difference| and the gradient scale,
     reported and not gated; the lossless gradient's host wall and the
     time of the row gather's transpose in it (profiled).
  5. The train step (make_train_step) single-tier at K 1,024, two-tier
     at K 512 and at K 384: ms, Gaussians/s and peak memory, zero
     truncation asserted on the initial state, after each warm-up step
     and after the timed steps.

Prints one JSON line. Times are CUDA events on a card and the host's
clock on the CPU (the line names the device and the timer).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from robosimgs_tpu_torch.render.binning import (bin_and_gather_packed,
                                                per_gaussian_cover)
from robosimgs_tpu_torch.render.project import project
from robosimgs_tpu_torch.render.rasterize import rasterize
from robosimgs_tpu_torch.render.tiles import num_tiles, tile_bbox
from robosimgs_tpu_torch.tools import workloads
from robosimgs_tpu_torch.tools.k_equiv import (device_name, grad_delta,
                                               loss_and_grads,
                                               time_train_step, train_state)
from robosimgs_tpu_torch.tools.workloads import (STAGED_BBOX, STAGED_K,
                                                 STAGED_K_LOSSLESS, STAGED_M,
                                                 STAGED_SPLIT, staged_config)
from robosimgs_tpu_torch.train.losses import psnr

K_ROUND = 512
WARMUP = 2
# every capacity's render against the lossless one (bench.py's gate)
MIN_DB = 60.0


def draw_covers(g, cam) -> dict:
    """The draw at the staged config's 16-px tiles: "proj" (its
    projection), "bbox" (each Gaussian's inclusive tile bbox tx0, ty0,
    tx1, ty1 from its radius, taken as 0 where not valid), "bbox_cover"
    (N,) and "survivor_cover" (N,) after the exact cull
    (`per_gaussian_cover` over the largest bbox)."""
    cfg = staged_config()
    W, H = cam.width, cam.height
    with torch.no_grad():
        proj = project(g, cam, cfg)
        tiles_x, tiles_y = num_tiles(W, H, cfg.tile_size)
        radii = torch.where(proj.valid, proj.radii,
                            torch.zeros_like(proj.radii))
        bbox = tile_bbox(proj.means2d, radii, tiles_x, tiles_y, cfg.tile_size)
        tx0, ty0, tx1, ty1 = bbox
        cover = ((tx1 - tx0 + 1).clamp_min(0)
                 * (ty1 - ty0 + 1).clamp_min(0))
        surv = per_gaussian_cover(proj, W, H, cfg, max(1, int(cover.max())))
    return {"proj": proj, "bbox": bbox, "bbox_cover": cover,
            "survivor_cover": surv}


def measure_draw(g, cam, split: int = STAGED_SPLIT,
                 covers: dict | None = None) -> dict:
    """The draw's covers and demand at the staged config's 16-px tiles
    (step 1 of the module docstring); covers: `draw_covers(g, cam)`, if
    at hand."""
    c = covers or draw_covers(g, cam)
    max_bbox = max(1, int(c["bbox_cover"].max()))
    surv = c["survivor_cover"]
    max_surv = max(1, int(surv.max()))
    with torch.no_grad():
        *_, st = bin_and_gather_packed(c["proj"], cam.width, cam.height,
                                       staged_config(K_ROUND, m=max_surv,
                                                     bbox=max_bbox))
    if int(st.truncated_gaussians) != 0:
        raise AssertionError("the draw's lossless binning truncates")
    return {"max_bbox_cover": max_bbox, "max_survivor_cover": max_surv,
            "max_tile_demand": int(st.max_tile_count),
            "total_pairs": int(st.total_pairs),
            "rows_over_split": int((surv > split).sum()), "split": split}


def measure_steps(g, cam, k: int, n_steps: int, wide: int,
                  target: torch.Tensor, split: int = STAGED_SPLIT) -> dict:
    """`measure_draw` on the initial state and after each of n_steps
    train steps at capacity k, one tier, M and bbox `wide` (raises if a
    cover reaches past it): the largest of each number over the states.
    Without truncation the pairs each tile renders do not depend on M,
    bbox or the tiers, so these are the states a run at any lossless M,
    bbox and split at this k passes through."""
    st, step_fn = train_state(g, cam, staged_config(k, m=wide, bbox=wide),
                              target)
    draws = []
    for i in range(n_steps + 1):
        draws.append(measure_draw(st.gaussians, cam, split))
        if draws[-1]["max_bbox_cover"] > wide:
            raise AssertionError(f"K{k} step {i}: a bbox cover "
                                 f"{draws[-1]['max_bbox_cover']} past {wide}")
        if i < n_steps:
            st, _ = step_fn(st, cam, target)
    return {key: max(d[key] for d in draws) for key in draws[0]}


def size_to_draw(draw: dict, m: int = STAGED_M, bbox: int = STAGED_BBOX,
                 k_lossless: int = STAGED_K_LOSSLESS):
    """(M, bbox, lossless K, notes): the given constants where the
    draw's numbers fit them, else the least that does (step 2); notes
    say which."""
    notes = []
    if draw["max_survivor_cover"] > m:
        notes.append(f"M {m} < max survivor cover "
                     f"{draw['max_survivor_cover']}: M = "
                     f"{draw['max_survivor_cover']}")
        m = draw["max_survivor_cover"]
    if draw["max_bbox_cover"] > bbox:
        notes.append(f"bbox {bbox} < max bbox cover {draw['max_bbox_cover']}"
                     f": bbox = {draw['max_bbox_cover']}")
        bbox = draw["max_bbox_cover"]
    if draw["max_tile_demand"] > k_lossless:
        need = -(-draw["max_tile_demand"] // K_ROUND) * K_ROUND
        notes.append(f"lossless K {k_lossless} < max tile demand "
                     f"{draw['max_tile_demand']}: K = {need}")
        k_lossless = need
    if not notes:
        notes.append(f"the draw fits M {m}, bbox {bbox} and lossless K "
                     f"{k_lossless}: kept")
    return m, bbox, k_lossless, notes


def _stats(st) -> dict:
    return {"truncated": int(st.truncated_gaussians),
            "overflowed_tiles": int(st.overflowed_tiles),
            "max_tile_count": int(st.max_tile_count),
            "total_pairs": int(st.total_pairs)}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def staged_lossless(g, cam, m: int = STAGED_M, bbox: int = STAGED_BBOX,
                    k_lossless: int = STAGED_K_LOSSLESS,
                    k_cands=(2048, 1024), k_staged: int = STAGED_K,
                    split: int = STAGED_SPLIT, timed=None,
                    iters: int = 10, log=None) -> dict:
    """Steps 1-5 of the module docstring on (g, cam); m, bbox and
    k_lossless are the constants to keep where the draw fits them.
    timed: the timed steps as (K, two-tier at the split or one tier),
    by default the JAX script's single tier at K 1,024, then two-tier
    at K 512 and at k_staged. log, if given, gets a line for each result
    as it comes (the draw, the sizing, each render, the gradient check,
    each step), so a failure shows what came before it.
    Raises AssertionError on a truncated render or step and on a gate
    below MIN_DB. Returns the JSON line's dict, with "configs": the
    RenderConfigs it ran, by name (not serialised by the CLI)."""
    dev = g.device
    W, H = cam.width, cam.height
    log = log or (lambda line: None)
    timed = timed or ((1024, False), (512, True), (k_staged, True))
    target = torch.zeros((H, W, 3), device=dev)
    draw = measure_draw(g, cam, split)
    log(f"draw of {g.capacity} Gaussians at {W}x{H}: {draw}")
    wide = 2 * max(draw["max_bbox_cover"], bbox)
    runs = {k: measure_steps(g, cam, k, WARMUP + iters, wide, target, split)
            for k in sorted({k for k, _ in timed})}
    for k, run in runs.items():
        log(f"over the {WARMUP + iters} train steps at K{k}: {run}")
    # the draw's demand sizes the lossless K (its renders are of the draw)
    most = {key: max([draw[key]] + [r[key] for r in runs.values()])
            for key in ("max_bbox_cover", "max_survivor_cover",
                        "rows_over_split")}
    m, bbox, k_lossless, notes = size_to_draw({**draw, **most}, m, bbox,
                                              k_lossless)
    # the spill tier holds every Gaussian past the split (bin_and_gather
    # rounds S = frac * n up to a multiple of 128)
    frac = (most["rows_over_split"] + 0.5) / g.capacity
    log("; ".join(notes) + f"; spill fraction {frac:.6f}")
    cfgs = {f"K{k}": staged_config(k, m=m, bbox=bbox)
            for k in (k_lossless, *k_cands)}
    staged_name = f"K{k_staged} tt{split}"
    cfgs[staged_name] = staged_config(k_staged, split, frac, m, bbox)
    renders, rgb = {}, {}
    with torch.no_grad():
        for name, cfg in cfgs.items():
            out = rasterize(g, cam, cfg, impl="tiled", return_stats=True)
            renders[name] = _stats(out["stats"])
            log(f"render {name}: {renders[name]}")
            if renders[name]["truncated"] != 0:
                raise AssertionError(f"{name}: {renders[name]['truncated']} "
                                     f"truncated Gaussians")
            rgb[name] = out["rgb"]
    ref = f"K{k_lossless}"
    gate = {name: float(psnr(rgb[name], rgb[ref]))
            for name in cfgs if name != ref}
    del rgb
    log("against the lossless render " + ", ".join(
        f"{name} {db:.2f} dB" for name, db in gate.items()))
    low = {k: v for k, v in gate.items() if not v >= MIN_DB}
    if low:
        raise AssertionError(f"capacity gates below {MIN_DB} dB against "
                             f"{ref}: {low}")

    # the gradient check: one gradient at the staged K against the
    # lossless one, the latter profiled for its gather transpose
    _, _, g_staged, _ = loss_and_grads(g, cam, cfgs[staged_name], target)
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    _sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _, _, g_ref, _ = loss_and_grads(g, cam, cfgs[ref], target)
        _sync(dev)
        lossless_grad_ms = (time.perf_counter() - t0) * 1e3
    transpose_ms = None
    if dev.type == "cuda":
        # what binning's _GatherRows backward ran on the device
        transpose_ms = sum(
            e.device_time_total for e in prof.events()
            if e.name == "autograd::engine::evaluate_function: "
                         "_GatherRowsBackward") / 1e3
    diff, scale = grad_delta(g_staged, g_ref)
    del g_staged, g_ref, prof
    log(f"gradient {staged_name} against {ref}: max |difference| "
        f"{diff:.3e} of scale {scale:.3e} (not gated); the lossless "
        f"gradient {lossless_grad_ms:.1f} ms host wall (profiled), its "
        f"gather transpose {transpose_ms} ms of device time")

    def no_truncation(cfg, name):
        def check(state):
            with torch.no_grad():
                *_, st = bin_and_gather_packed(
                    project(state.gaussians, cam, cfg), W, H, cfg)
            n_trunc = int(st.truncated_gaussians)
            if n_trunc != 0:
                now = measure_draw(state.gaussians, cam, split)
                raise AssertionError(
                    f"{name} at step {state.step}: {n_trunc} truncated "
                    f"Gaussians (M {cfg.max_tiles_per_gaussian}, bbox "
                    f"{cfg.bbox_tiles_per_gaussian}; the Gaussians now: "
                    f"{now})")
        return check

    steps = []
    for k, two_tier in timed:
        sp = split if two_tier else 0
        name = f"K{k} tt{sp}" if two_tier else f"K{k} single"
        cfg = staged_config(k, sp, frac if two_tier else 0.0, m, bbox)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        ms = time_train_step(g, cam, cfg, target, reps=iters, warmup=WARMUP,
                             check=no_truncation(cfg, name))
        steps.append({"name": name, "K": k, "split": sp, "ms": ms,
                      "gaussians_per_s": g.capacity / (ms / 1e3),
                      "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else None)})
        log(f"train step {name}: {steps[-1]}")
        cfgs[f"step {name}"] = cfg
    return {"tool": "staged_lossless", "device": device_name(dev),
            "timer": workloads.timer(dev)[1], "n": g.capacity, "res": [W, H],
            "draw": draw, "over_steps": {f"K{k}": r for k, r in runs.items()},
            "constants": {"M": STAGED_M, "bbox": STAGED_BBOX,
                          "K_lossless": STAGED_K_LOSSLESS},
            "sized": {"M": m, "bbox": bbox, "K_lossless": k_lossless,
                      "spill_frac": frac, "notes": notes},
            "renders": renders, "gate_psnr": gate, "min_db": MIN_DB,
            "grad_check": {"staged": staged_name, "max_grad_diff": diff,
                           "grad_scale": scale,
                           "lossless_grad_ms": lossless_grad_ms,
                           "transpose_ms": transpose_ms},
            "steps": steps, "configs": cfgs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=workloads.STAGED_GAUSSIANS)
    ap.add_argument("--res", type=int, default=workloads.STAGED_RES)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--k-cands", type=int, nargs="+", default=[2048, 1024],
                    help="single-tier capacities gated against the lossless")
    ap.add_argument("--k-staged", type=int, default=STAGED_K,
                    help="the two-tier capacity gated and timed")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = workloads.open_device(args.device, "staged_lossless")
    if dev is None:
        return 1
    g, cam = workloads.staged_scene(dev, n=args.n, res=args.res)
    res = staged_lossless(g, cam, k_cands=args.k_cands,
                          k_staged=args.k_staged, iters=args.iters)
    res.pop("configs")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
