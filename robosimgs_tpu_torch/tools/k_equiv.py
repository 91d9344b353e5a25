"""Tile-capacity equivalence: render PSNR and gradient deltas at each
capacity K against a lossless K, and the train step's time at each K.

    python -m robosimgs_tpu_torch.tools.k_equiv [--ks 5120:512,1024:0,...]
        [--n 100000] [--res 256] [--m 12] [--reps 30] [--device cuda]

A port of the JAX package's scripts/k_equiv.py. Saturated tiles stop
compositing long before their capacity, so a K that overflows may still
render what the lossless K renders; this measures whether it does. Each
--ks entry is K:tile_chunk, the first the lossless reference. On the
bench scene (tools/workloads.py: 100k Gaussians, SH 3, 256x256, seed 0)
at RenderConfig(tile_capacity=K, max_tiles_per_gaussian=M,
tile_chunk=chunk), as the JAX script, against a zero target:

  * loss, rgb and the gradient of every float field at each K (one
    forward and backward through the compositing kernels);
  * each other K against the first: render PSNR, the largest |gradient
    difference| over all fields and the gradient scale (the reference's
    largest |gradient|);
  * each other K's train step (train/trainer.py's make_train_step with
    L1 + SSIM and the per-group Adam): ms and Gaussians/s.

Prints one JSON line. Times are CUDA events on a card and the host's
clock on the CPU (the line names the device and the timer).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.project import project
from robosimgs_tpu_torch.render.tiled import composite_tiled
from robosimgs_tpu_torch.tools import workloads
from robosimgs_tpu_torch.train.data import Frame
from robosimgs_tpu_torch.train.losses import photometric_loss, psnr
from robosimgs_tpu_torch.train.optim import FLOAT_FIELDS
from robosimgs_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                               make_train_step)

DEFAULT_KS = "5120:512,1024:0,512:0,768:0"


def parse_ks(text: str):
    """'K:chunk,K:chunk,...' -> [(K, chunk), ...] (the JAX script's KEQ_KS)."""
    return [tuple(int(v) for v in x.split(":")) for x in text.split(",")]


def device_name(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def loss_and_grads(g, cam, cfg: RenderConfig, target: torch.Tensor):
    """(loss, rgb, {field: gradient}, BinStats) of the photometric loss of
    g's render through the tiled path (both compositing kernels on the
    card), every float field a leaf."""
    params = {k: getattr(g, k).detach().requires_grad_() for k in FLOAT_FIELDS}
    out = composite_tiled(project(g.replace(**params), cam, cfg), cam.width,
                          cam.height, cfg, return_stats=True)
    loss = photometric_loss(out["rgb"], target)
    grads = torch.autograd.grad(loss, list(params.values()))
    return (loss.detach(), out["rgb"].detach(), dict(zip(params, grads)),
            out["stats"])


def grad_delta(grads: dict, ref: dict):
    """(max |grads - ref| over every field, max |ref|)."""
    return (max(float((grads[k] - ref[k]).abs().max()) for k in ref),
            max(float(v.abs().max()) for v in ref.values()))


def train_config(cfg: RenderConfig) -> TrainConfig:
    """The Trainer's config for a step at cfg that only trains: every SH
    band on, no densification, opacity reset or pool resize."""
    return TrainConfig(render=cfg, impl="tiled", sh_warmup_every=1,
                       densify_from=10**9, opacity_reset_interval=10**9,
                       dynamic_pool=False, log_every=10**9)


def train_state(g, cam, cfg: RenderConfig, target: torch.Tensor):
    """(the Trainer's initial state of g on one frame, make_train_step's
    step) at cfg; step_fn(state, cam, target) -> (state, metrics)."""
    tcfg = train_config(cfg)
    st = Trainer(tcfg, g, [Frame(camera=cam,
                                 image=target.cpu().numpy())]).state
    return st, make_train_step(tcfg, "tiled")


def time_train_step(g, cam, cfg: RenderConfig, target: torch.Tensor,
                    reps: int, warmup: int = 3, check=None) -> float:
    """Mean ms of make_train_step's step at cfg (the device's timer) over
    reps steps after warmup steps, from the Trainer's initial state of g
    (the state carries over). check(state), if given, runs on the
    initial state, after each warm-up step and after the timed steps."""
    st, step_fn = train_state(g, cam, cfg, target)

    def step():
        nonlocal st
        st, _ = step_fn(st, cam, target)

    for i in range(warmup + 1):
        if check is not None:
            check(st)
        if i < warmup:
            step()
    ms = workloads.timer(g.device)[0](step, reps=reps, warmup=0)
    if check is not None:
        check(st)
    return ms


def k_equiv(g, cam, ks=parse_ks(DEFAULT_KS), m: int = 12,
            reps: int = 30) -> dict:
    """The measurements of the module docstring on (g, cam); ks[0] is the
    lossless reference. Returns the JSON line's dict."""
    dev = g.device
    target = torch.zeros((cam.height, cam.width, 3), device=dev)
    cfgs = {k: RenderConfig(tile_capacity=k, max_tiles_per_gaussian=m,
                            tile_chunk=chunk) for k, chunk in ks}
    k_ref = ks[0][0]
    outs, grads, per_k = {}, {}, {}
    for k, _ in ks:
        loss, rgb, gr, st = loss_and_grads(g, cam, cfgs[k], target)
        outs[k], grads[k] = rgb, gr
        per_k[k] = {"K": k, "loss": float(loss),
                    "truncated": int(st.truncated_gaussians),
                    "overflowed_tiles": int(st.overflowed_tiles),
                    "max_tile_count": int(st.max_tile_count)}
    for k, _ in ks[1:]:
        diff, scale = grad_delta(grads[k], grads[k_ref])
        per_k[k].update(psnr=float(psnr(outs[k], outs[k_ref])),
                        max_grad_diff=diff, grad_scale=scale)
    del outs, grads
    for k, _ in ks[1:]:
        ms = time_train_step(g, cam, cfgs[k], target, reps)
        per_k[k].update(step_ms=ms, gaussians_per_s=g.capacity / (ms / 1e3))
    return {"tool": "k_equiv", "device": device_name(dev),
            "timer": workloads.timer(dev)[1], "n": g.capacity,
            "res": [cam.width, cam.height], "M": m, "k_ref": k_ref,
            "ks": [per_k[k] for k, _ in ks]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ks", default=DEFAULT_KS,
                    help="K:tile_chunk,... the first the lossless reference")
    ap.add_argument("--n", type=int, default=workloads.BENCH_GAUSSIANS)
    ap.add_argument("--res", type=int, default=workloads.BENCH_RES)
    ap.add_argument("--m", type=int, default=12,
                    help="max_tiles_per_gaussian at every K")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = workloads.open_device(args.device, "k_equiv")
    if dev is None:
        return 1
    g, _, _ = workloads.bench_scene(dev, n=args.n)
    cam = Camera.look_at([4.0, 0.5, 1.2], [0, 0, 0], [0, 0, 1], 60.0,
                         args.res, args.res, device=dev)
    print(json.dumps(k_equiv(g, cam, parse_ks(args.ks), args.m, args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
