"""Seven arms of the training quality features on the flagship scene.

    python -m robosimgs_tpu_torch.tools.ab_features [out.json] [--res 512]
        [--iters 1500] [--capacity 100000] [--views 24] [--holdout 4]
        [--init N] [--arms baseline,absgrad,...] [--device cuda]

A port of the JAX package's scripts/ab_features.py, with its
parameters, numpy seeds and output keys. Every arm trains the flagship
capture (tools/flagship.py::build_scene(11, ...), with the targets'
depth) from the same noisy surface samples and the same pool:
baseline, absgrad densification, the antialiased (mip-splatting) mode,
the scale regularizer, the bilateral grid, depth supervision and the
normal regularizer. Per arm it reports held-out PSNR, the final loss,
the alive count, the last logged overflow, the median max/min scale
ratio of the live Gaussians and it/s, and rewrites the JSON after
each arm, so a run cut short keeps the arms it finished.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from robosimgs_tpu_torch.core.types import Gaussians
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.tools.flagship import build_scene, holdout_split
from robosimgs_tpu_torch.train.densify import DensifyConfig
from robosimgs_tpu_torch.train.optim import OptimConfig
from robosimgs_tpu_torch.train.trainer import TrainConfig, Trainer

ARMS = ("baseline", "absgrad", "antialiased", "scale_reg", "bilagrid",
        "depth", "normal_reg")


def arm_configs(iters: int) -> dict:
    """{arm: TrainConfig}: the base config (K 1,536, the tiled path,
    densify from 300 every 150 steps) and each arm's one change."""
    base_render = RenderConfig(tile_capacity=1536)
    base = TrainConfig(
        iterations=iters, render=base_render, impl="tiled",
        background=(1.0, 1.0, 1.0), scene_extent=3.0,
        optim=OptimConfig(means_lr_max_steps=iters),
        densify=DensifyConfig(grad_threshold=1.5e-4),
        densify_from=300, densify_until=int(iters * 0.7),
        densify_interval=150, opacity_reset_interval=10_000,
        dynamic_pool=False, log_every=100,
    )
    return {
        "baseline": base,
        "absgrad": dataclasses.replace(
            base, render=dataclasses.replace(base_render, absgrad=True),
            densify=dataclasses.replace(base.densify, grad_threshold=6e-4)),
        "antialiased": dataclasses.replace(
            base, render=dataclasses.replace(base_render, antialiased=True)),
        "scale_reg": dataclasses.replace(base, scale_reg_lambda=0.02,
                                         scale_reg_max_ratio=8.0),
        "bilagrid": dataclasses.replace(base, bilateral_grid=True),
        "depth": dataclasses.replace(base, depth_lambda=0.1),
        "normal_reg": dataclasses.replace(
            base, normal_lambda=0.02,
            render=dataclasses.replace(base_render, render_normals=True)),
    }


def arm_result(trainer: Trainer, seconds: float) -> dict:
    """One arm's row of the JSON, from its trained state."""
    g = trainer.state.gaussians
    ls = g.log_scales.detach().cpu().numpy()
    alive = g.alive.cpu().numpy()
    ratio = float(np.median(np.exp(ls.max(-1) - ls.min(-1))[alive]))
    return {
        "eval_psnr": round(trainer.eval_psnr(), 2),
        "final_loss": round(trainer.history[-1]["loss"], 5),
        "alive": int(g.num_alive),
        "overflow": int(trainer.history[-1].get("overflow", 0)),
        "median_scale_ratio": round(ratio, 2),
        "iters_per_sec": round(trainer.cfg.iterations / seconds, 2),
    }


def run(out_path: str, res: int = 512, iters: int = 1500,
        capacity: int = 100_000, n_views: int = 24, n_hold: int = 4,
        n_init=None, arms=None, device="cuda", progress: bool = True,
        frames=None, scene=None) -> dict:
    """Train every arm (or those named in `arms`) and write out_path
    after each; returns {"arms": {arm: row}, "seconds": {arm: the host
    wall of its training run}}. frames / scene: an earlier
    build_scene(11, n_views, res, with_depth=True), if at hand."""
    dev = torch.device(device)
    if frames is None:
        scene, frames = build_scene(11, n_views, res, with_depth=True,
                                    device=dev)
    train_frames, eval_frames = holdout_split(frames, n_hold)
    if progress:
        print(f"{len(train_frames)} train views, {len(eval_frames)} held "
              f"out, {res}x{res}", flush=True)
    cfgs = arm_configs(iters)
    if arms:
        keep = set(arms)
        cfgs = {k: v for k, v in cfgs.items() if k in keep}

    # the noisy surface samples every arm starts from
    rng = np.random.default_rng(0)
    n_init = min(8_000, capacity // 4) if n_init is None else n_init
    pts = scene.sample_surface(n_init, seed=1)
    pts = (pts + rng.normal(scale=0.01, size=pts.shape)).astype(np.float32)

    results, seconds = {}, {}
    for name, cfg in cfgs.items():
        init = Gaussians.from_points(pts, sh_degree=2, capacity=capacity,
                                     device=dev)
        trainer = Trainer(cfg, init, train_frames, eval_frames=eval_frames)
        t0 = time.time()
        trainer.run(progress=False)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds[name] = time.time() - t0
        results[name] = arm_result(trainer, seconds[name])
        if progress:
            print(f"{name}: {results[name]}", flush=True)
        with open(out_path, "w") as fh:
            json.dump({"config": {"res": res, "iters": iters,
                                  "capacity": capacity,
                                  "views": len(train_frames),
                                  "holdout": len(eval_frames),
                                  "scene": "flagship build_scene(11)"},
                       "arms": results}, fh, indent=1)
    if progress:
        print("AB_RESULTS " + json.dumps(results), flush=True)
    return {"arms": results, "seconds": seconds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="ab_features.json")
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--iters", type=int, default=1500)
    ap.add_argument("--capacity", type=int, default=100_000)
    ap.add_argument("--views", type=int, default=24)
    ap.add_argument("--holdout", type=int, default=4)
    ap.add_argument("--init", type=int, default=None,
                    help="initial points (default min(8000, capacity / 4))")
    ap.add_argument("--arms", default="",
                    help="comma list of arms to run (default all): "
                    + ",".join(ARMS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("ab_features: no CUDA device (--device cpu runs the plain "
              "versions)", file=sys.stderr)
        return 1
    arms = [a.strip() for a in args.arms.split(",") if a.strip()]
    run(args.out, res=args.res, iters=args.iters, capacity=args.capacity,
        n_views=args.views, n_hold=args.holdout, n_init=args.init,
        arms=arms or None, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
