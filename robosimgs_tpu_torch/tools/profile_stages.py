"""Per-stage latency of the train step, and where its device time goes.

    python -m robosimgs_tpu_torch.tools.profile_stages [--config bench]
        [--n 100000] [--res 256] [--k 512] [--m 10] [--bbox 12]
        [--tt 4] [--tt-frac 0.15] [--reps 30] [--device cuda]
    python -m robosimgs_tpu_torch.tools.profile_stages --config feasibility

A port of the JAX package's scripts/profile_stages.py: each stage of
the train step timed alone (`STAGES`, the JAX script's names with the
port's kernels in place of the Pallas pair), the mean of --reps calls
after warm-up (CUDA events on a card, the host's clock on the CPU):
projection; binning's sub-stages as `bin_and_gather_packed` runs them
(the depth argsort, the permute of the narrow bbox inputs, the tile ids
with the exact cull and the row compaction (one kernel on a card), the
int64 key pack, the key sort, searchsorted, the selection window, the
packed feature gather);
the transpose of the gather (binning's backward as the train step runs
it: each Gaussian's rows summed over its kept entries); binning whole;
each compositing kernel; L1 + SSIM forward and backward; the per-group
Adam update; the forward render, a value-and-grad and the train step
(train/trainer.py's make_train_step), end to end.

The JAX script's environment overrides (RSGS_PROF_K, _M, _BBOX, _TT,
_TT_FRAC) are arguments here, with its defaults: the bench scene
(tools/workloads.py: 100k Gaussians, SH 3, 256x256) at K 512, M 10 over
a 12-tile bbox, two-tier 4 / 0.15. --config feasibility runs the 3M
512x512 scene at `feasibility_config()` instead (32-px tiles, K 2048,
M 16, bbox 20, one tier).

Then one train step under torch.profiler: its device time by the
operation that launched it, attributed to the package function that ran
the operation or, in the backward, to the function whose forward
operation the autograd node differentiates (`attribute_ops`).

Prints one JSON line for the config, in ms.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import sys

import torch

from robosimgs_tpu_torch.render.binning import bin_and_gather_packed, pack16
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.cull import bin_cull_compact
from robosimgs_tpu_torch.render.kernels import composite_bwd, composite_fwd
from robosimgs_tpu_torch.render.project import project
from robosimgs_tpu_torch.render.rasterize import rasterize
from robosimgs_tpu_torch.render.tiles import cull_qcut, num_tiles, tile_bbox
from robosimgs_tpu_torch.tools import workloads
from robosimgs_tpu_torch.tools.k_equiv import (device_name, loss_and_grads,
                                               time_train_step, train_config)
from robosimgs_tpu_torch.train.data import Frame
from robosimgs_tpu_torch.train.losses import photometric_loss
from robosimgs_tpu_torch.train.optim import float_params, make_optimizer
from robosimgs_tpu_torch.train.trainer import Trainer, make_train_step
from robosimgs_tpu_torch.utils.profiling import device_rows

# the stages in the JAX script's order and under its names; the key
# sort's name carries its key count, as there ("sort(1000k)")
STAGES = ("project", "argsort", "narrow-permute", "tid-expand", "key-pack",
          "sort", "searchsorted", "sel-window", "feat-gather",
          "gather-transpose(bwd)", "bin_and_gather(fused)", "composite_fwd",
          "composite_bwd", "loss-bwd", "adam", "fwd render e2e",
          "value_and_grad e2e", "train step e2e")
# the JAX script's names for the stages the port renames
JAX_NAMES = {"composite_fwd": "pallas-fwd", "composite_bwd": "pallas-bwd"}
PACKAGE = "robosimgs_tpu_torch/"
# rows of the train step's attribution kept in the JSON line
TOP = 25
BACKWARD = "autograd::engine::evaluate_function: "


def bench_profile_config(k: int = 512, m: int = 10, bbox: int = 12,
                         tt: int = 4, tt_frac: float = 0.15) -> RenderConfig:
    """The JAX script's default config (its RSGS_PROF_* overrides)."""
    return RenderConfig(tile_capacity=k, max_tiles_per_gaussian=m,
                        bbox_tiles_per_gaussian=bbox, two_tier_split=tt,
                        two_tier_spill_frac=tt_frac)


def binning_stages(proj, width: int, height: int, cfg: RenderConfig):
    """[(stage, fn)] of `bin_and_gather_packed`'s sub-stages, each fn a
    closure over the previous stages' outputs (computed here once), and
    the last stage's outputs (geom, feat, sel): the same numbers as
    bin_and_gather_packed's (tests hold them equal)."""
    tiles_x, tiles_y = num_tiles(width, height, cfg.tile_size)
    T = tiles_x * tiles_y
    n = proj.means2d.shape[0]
    M, K = cfg.max_tiles_per_gaussian, cfg.tile_capacity
    Mb = max(cfg.bbox_tiles_per_gaussian, M)
    Ms = cfg.two_tier_split
    two_tier = 0 < Ms < M
    dev = proj.means2d.device
    bits = max(1, (n - 1).bit_length())
    k_ar = torch.arange(K, device=dev)
    zero = torch.zeros((), dtype=proj.means2d.dtype, device=dev)
    inf = torch.full_like(proj.depths, math.inf)
    stages, out = [], {}

    def stage(name):
        def add(fn):
            stages.append((name, fn))
            out[name] = fn()
            return fn
        return add

    @stage("argsort")
    def argsort():
        return torch.argsort(torch.where(proj.valid, proj.depths.detach(),
                                         inf), stable=True)

    @stage("narrow-permute")
    def permute():
        bbox_in = torch.stack([
            proj.means2d[:, 0], proj.means2d[:, 1],
            torch.where(proj.valid, proj.radii.to(zero.dtype), zero),
            proj.conics[:, 0], proj.conics[:, 1], proj.conics[:, 2],
            torch.where(proj.valid, proj.opacities, zero)], dim=1).detach()
        return bbox_in[out["argsort"]]

    @stage("tid-expand")
    def tid_expand():
        bbox_s = out["narrow-permute"]
        m2d_s, radii_s = bbox_s[:, 0:2], bbox_s[:, 2]
        tx0, ty0, tx1, ty1 = tile_bbox(m2d_s, radii_s, tiles_x, tiles_y,
                                       cfg.tile_size)
        qcut = (cull_qcut(bbox_s[:, 6], cfg.alpha_min)
                if cfg.exact_tile_cull else None)
        tid, surv, _ = bin_cull_compact(
            bbox_s, qcut, tx0, ty0, tx1, ty1, tiles_x=tiles_x, n_tiles=T,
            n_slots=Mb, max_tiles=M, tile_size=cfg.tile_size)
        return tid, surv

    @stage("key-pack")
    def key_pack():
        tid, surv = out["tid-expand"]
        rank = torch.arange(n, device=dev)
        if not two_tier:
            return ((tid << bits) | rank[:, None]).reshape(-1)
        S = min(n, max(128, -(-int(cfg.two_tier_spill_frac * n) // 128)
                       * 128))
        key1 = (tid[:, :Ms] << bits) | rank[:, None]
        spill_idx = torch.sort(surv, descending=True, stable=True).indices[:S]
        key2 = (tid[:, Ms:][spill_idx] << bits) | spill_idx[:, None]
        return torch.cat([key1.reshape(-1), key2.reshape(-1)])

    sort = f"sort({out['key-pack'].shape[0] // 1000}k)"
    stage(sort)(lambda: torch.sort(out["key-pack"]).values)
    s_key = out[sort]
    queries = torch.arange(T + 1, device=dev) << bits
    stage("searchsorted")(lambda: torch.searchsorted(s_key, queries))

    @stage("sel-window")
    def sel_window():
        bounds = out["searchsorted"]
        s_key_pad = torch.cat([s_key, torch.full((K,), (T + 1) << bits,
                                                 device=dev)])
        win = s_key_pad[torch.clamp_max(bounds[:-1], s_key.shape[0])[:, None]
                        + k_ar[None, :]]
        counts = torch.clamp_max(bounds[1:] - bounds[:-1], K)
        kmask = k_ar[None, :] < counts[:, None]
        sel_rank = win & ((1 << bits) - 1)
        return (out["argsort"][torch.where(kmask, sel_rank,
                                           torch.zeros_like(sel_rank))],
                kmask)

    @stage("feat-gather")
    def feat_gather():
        sel, kmask = out["sel-window"]
        gathered = pack16(proj)[sel]
        op = torch.where(kmask, gathered[:, :, 5],
                         torch.zeros_like(gathered[:, :, 5]))
        gathered = torch.cat([gathered[:, :, :5], op[:, :, None],
                              gathered[:, :, 6:]], dim=2).transpose(1, 2)
        return gathered[:, :8].contiguous(), gathered[:, 8:].contiguous()

    geom, feat = out["feat-gather"]
    return stages, (geom, feat, out["sel-window"][0])


def stage_fns(g, cam, cfg: RenderConfig, target: torch.Tensor):
    """[(stage, fn)] of every stage, in STAGES' order, each fn running
    the stage once on the outputs of the stages before it."""
    W, H = cam.width, cam.height
    tiles_x, _ = num_tiles(W, H, cfg.tile_size)
    dev = g.device
    with torch.no_grad():
        proj = project(g, cam, cfg)
        binning, (geom, feat, sel) = binning_stages(proj, W, H, cfg)
        *_, counts, _ = bin_and_gather_packed(proj, W, H, cfg)
    kw = dict(tiles_x=tiles_x, cfg=cfg, has_dlim=False)
    fwd = composite_fwd(geom, feat, counts, None, **kw)
    gout = torch.ones_like(fwd[0])
    # the transpose alone: binning's backward on a kept graph, to one
    # leaf of the packed rows (its other inputs need no gradient)
    leaf = proj.means2d.detach().requires_grad_()
    blocks = bin_and_gather_packed(dataclasses.replace(proj, means2d=leaf),
                                   W, H, cfg)[:2]
    ct = [torch.ones_like(b) for b in blocks]
    img = torch.full((H, W, 3), 0.3, device=dev, requires_grad=True)
    optimizer = make_optimizer()
    params = float_params(g)
    opt_state = optimizer.init(params)

    def no_grad(fn):
        def run():
            with torch.no_grad():
                return fn()
        return run

    return ([("project", no_grad(lambda: project(g, cam, cfg)))]
            + [(name, no_grad(fn)) for name, fn in binning]
            + [("gather-transpose(bwd)", lambda: torch.autograd.grad(
                blocks, leaf, ct, retain_graph=True)),
               ("bin_and_gather(fused)", no_grad(
                   lambda: bin_and_gather_packed(proj, W, H, cfg))),
               ("composite_fwd", lambda: composite_fwd(geom, feat, counts,
                                                       None, **kw)),
               ("composite_bwd", lambda: composite_bwd(geom, feat, counts,
                                                       None, gout, *fwd[1:],
                                                       **kw)),
               ("loss-bwd", lambda: torch.autograd.grad(
                   photometric_loss(img, target), img)),
               ("adam", no_grad(lambda: optimizer.step(params, params,
                                                       opt_state))),
               ("fwd render e2e", no_grad(lambda: rasterize(
                   g, cam, cfg, impl="tiled"))),
               ("value_and_grad e2e", lambda: loss_and_grads(g, cam, cfg,
                                                             target))])


def _package_function(event):
    """'render/project.py(97): project', the innermost package frame of a
    profiler event: from its recorded Python stack (innermost first), or
    from the Python-function events around it where the profiler
    records those instead; None outside the package."""
    for frame in event.stack or ():
        if PACKAGE in frame:
            return frame.partition(PACKAGE)[2]
    while event is not None:
        if PACKAGE in event.name and "(" in event.name:
            return event.name.partition(PACKAGE)[2]
        event = event.cpu_parent
    return None


def attribute_ops(prof, n_steps: int = 1, on_device: bool = True):
    """[(where, operation, launches a step, ms a step)] of a profile run
    with_stack: each operation's own time (its device kernels' on a card,
    its host time otherwise) summed by operation and by where it ran. A
    forward operation is 'fwd <package frame>' (`_package_function`); a
    backward one 'bwd <package frame> <autograd node>', the frame of the
    forward operation the node differentiates (linked by autograd's
    sequence number); 'bwd AccumulateGrad' and such where none is."""
    def backward_node(e):
        while e is not None and not e.name.startswith(BACKWARD):
            e = e.cpu_parent
        return e

    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    # the operation that made a node is the last forward one to record
    # its sequence number (operations that make none record the next)
    forward = {e.sequence_nr: e for e in events
               if e.sequence_nr >= 0 and backward_node(e) is None}
    rows = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU \
                or e.name.startswith(BACKWARD) or PACKAGE in e.name:
            continue
        us = e.self_device_time_total if on_device else e.self_cpu_time_total
        if us <= 0:
            continue
        node = backward_node(e.cpu_parent)
        if node is None:
            where = f"fwd {_package_function(e)}"
        else:
            kind = node.name[len(BACKWARD):].rpartition("::")[2]
            fwd = forward.get(node.sequence_nr)
            where = " ".join(x for x in ("bwd", fwd and _package_function(fwd),
                                         kind) if x)
        row = rows[(where, e.name)]
        row[0] += len(e.kernels) if on_device else 1
        row[1] += us / 1e3
    return sorted(((w, op, c / n_steps, ms / n_steps)
                   for (w, op), (c, ms) in rows.items()),
                  key=lambda r: -r[3])


def by_operation(ops):
    """[(operation, launches, ms)] of `attribute_ops`' rows summed over
    where they ran, the most time first."""
    sums = collections.defaultdict(lambda: [0.0, 0.0])
    for _, op, n, ms in ops:
        sums[op][0] += n
        sums[op][1] += ms
    return sorted(((op, n, ms) for op, (n, ms) in sums.items()),
                  key=lambda r: -r[2])


def profile_stages(g, cam, cfg: RenderConfig, reps: int = 30) -> dict:
    """Every stage's mean ms over reps calls, and one profiled train
    step's top operations by `attribute_ops`. Returns the JSON line's
    dict."""
    dev = g.device
    time_fn, timer_name = workloads.timer(dev)
    target = torch.zeros((cam.height, cam.width, 3), device=dev)
    stages = {name: time_fn(fn, reps=reps)
              for name, fn in stage_fns(g, cam, cfg, target)}
    stages["train step e2e"] = time_train_step(g, cam, cfg, target, reps)
    tcfg = train_config(cfg)
    st = Trainer(tcfg, g, [Frame(camera=cam,
                                 image=target.cpu().numpy())]).state
    step_fn = make_train_step(tcfg, "tiled")
    st, _ = step_fn(st, cam, target)                       # warm-up
    from torch.profiler import ProfilerActivity, profile
    on_device = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_device else [])
    if on_device:
        torch.cuda.synchronize(dev)
    # verbose: the Python stack of each operation (torch 2.11 on the card
    # records it only so)
    with profile(activities=acts, with_stack=True,
                 experimental_config=torch.profiler._ExperimentalConfig(
                     verbose=True)) as prof:
        step_fn(st, cam, target)
        if on_device:
            torch.cuda.synchronize(dev)
    ops = attribute_ops(prof, 1, on_device)
    # every device operation, those no host operation launched included
    # (a kernel launched by ctypes outside any recorded operation)
    total_ms = (sum(e.self_device_time_total for e in device_rows(prof)) / 1e3
                if on_device else sum(r[3] for r in ops))
    tiles_x, tiles_y = num_tiles(cam.width, cam.height, cfg.tile_size)
    return {"tool": "profile_stages", "device": device_name(dev),
            "timer": timer_name, "n": g.capacity,
            "res": [cam.width, cam.height], "tile_size": cfg.tile_size,
            "M": cfg.max_tiles_per_gaussian,
            "bbox": cfg.bbox_tiles_per_gaussian, "K": cfg.tile_capacity,
            "two_tier": [cfg.two_tier_split, cfg.two_tier_spill_frac],
            "T": tiles_x * tiles_y, "reps": reps, "stages": stages,
            "step_ops_time": "device" if on_device else "host",
            "step_ops_total_ms": total_ms,
            "step_ops_attributed_ms": sum(r[3] for r in ops),
            "step_ops_by_op": [list(r) for r in by_operation(ops)[:TOP]],
            "step_ops_launches": sum(r[2] for r in ops),
            "step_ops": [list(r) for r in ops[:TOP]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("bench", "feasibility"),
                    default="bench")
    ap.add_argument("--n", type=int)
    ap.add_argument("--res", type=int)
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--bbox", type=int, default=12)
    ap.add_argument("--tt", type=int, default=4)
    ap.add_argument("--tt-frac", type=float, default=0.15)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = workloads.open_device(args.device, "profile_stages")
    if dev is None:
        return 1
    if args.config == "feasibility":
        g, cam, cfg = workloads.feasibility_scene(
            dev, n=args.n or workloads.FEASIBILITY_GAUSSIANS)
    else:
        g, cam, _ = workloads.bench_scene(
            dev, n=args.n or workloads.BENCH_GAUSSIANS)
        cfg = bench_profile_config(args.k, args.m, args.bbox, args.tt,
                                   args.tt_frac)
    if args.res:
        from robosimgs_tpu_torch.core.camera import Camera
        cam = Camera.look_at([4.0, 0.5, 1.2], [0, 0, 0], [0, 0, 1], 60.0,
                             args.res, args.res, device=dev)
    res = profile_stages(g, cam, cfg, args.reps)
    print(json.dumps({"config": args.config, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
