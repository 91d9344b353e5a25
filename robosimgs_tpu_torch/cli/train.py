"""Train a 3DGS scene: `python -m robosimgs_tpu_torch.cli.train ...`

The port of robosimgs_tpu/cli/train.py: consumes a Nerfstudio
transforms.json capture, a COLMAP sparse model or a synthetic scene,
trains on the card (or on the CPU with `--device cpu`) and exports a
standard 3DGS .ply plus train_summary.json.

    python -m robosimgs_tpu_torch.cli.train --synthetic 20000 \\
        --iterations 600 --output out/
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os


def build_parser():
    p = argparse.ArgumentParser(description="Train a 3D Gaussian Splatting scene")
    p.add_argument("--data", help="path to transforms.json (Nerfstudio format)")
    p.add_argument("--colmap", help="path to a COLMAP sparse dir "
                                    "(cameras/images/points3D.bin)")
    p.add_argument("--images", help="image dir for --colmap")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train a synthetic N-gaussian scene instead of --data")
    p.add_argument("--output", required=True, help="output directory")
    p.add_argument("--iterations", type=int, default=7000)
    p.add_argument("--capacity", type=int, default=500_000,
                   help="gaussian capacity pool size")
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--eval-every", type=int, default=8,
                   help="every Nth frame held out for eval")
    p.add_argument("--tile-capacity", type=int, default=1024)
    p.add_argument("--impl", default="auto",
                   choices=["auto", "reference", "tiled"])
    p.add_argument("--checkpoint-every", type=int, default=2000)
    p.add_argument("--background", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    p.add_argument("--scene-extent", type=float, default=None,
                   help="override the camera-derived scene extent "
                        "(scales means-lr and densify/prune thresholds)")
    p.add_argument("--absgrad", action="store_true",
                   help="densify on per-pixel |dL/dmean2d| (gsplat "
                        "absgrad; pair with a ~4x --grad-threshold)")
    p.add_argument("--grad-threshold", type=float, default=None,
                   help="densification gradient threshold override")
    p.add_argument("--antialiased", action="store_true",
                   help="mip-splatting opacity compensation")
    p.add_argument("--scale-reg", type=float, default=0.0,
                   help="scale-ratio regularizer weight (splatfacto "
                        "use_scale_regularization; 0 = off)")
    p.add_argument("--exposure", action="store_true",
                   help="per-frame affine exposure correction "
                        "(auto-exposure captures)")
    p.add_argument("--bilateral-grid", action="store_true",
                   help="per-frame bilateral-grid color correction "
                        "(splatfacto use_bilateral_grid: spatially-"
                        "varying affine for vignetting / local white-"
                        "balance drift)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: cuda)")
    p.add_argument("--trace", metavar="DIR", default=None,
                   help="profile one log interval of the run (the whole "
                        "run when it logs twice or less): write its Chrome "
                        "trace and span summary (utils/profiling.py) to DIR "
                        "and print binning's counters")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    from robosimgs_tpu_torch.core.types import Gaussians
    from robosimgs_tpu_torch.render.config import RenderConfig
    from robosimgs_tpu_torch.render.rasterize import rasterize
    from robosimgs_tpu_torch.train.data import (camera_extent,
                                                parse_transforms_json,
                                                synthetic_scene,
                                                train_eval_split)
    from robosimgs_tpu_torch.train.densify import DensifyConfig
    from robosimgs_tpu_torch.train.io_ply import save_ply
    from robosimgs_tpu_torch.train.trainer import TrainConfig, Trainer

    os.makedirs(args.output, exist_ok=True)
    dev = torch.device(args.device)
    render_cfg = RenderConfig(tile_capacity=args.tile_capacity,
                              absgrad=args.absgrad,
                              antialiased=args.antialiased)

    if args.synthetic:
        gt, frames = synthetic_scene(seed=0, n_gaussians=args.synthetic,
                                     n_cameras=24, width=256, height=256,
                                     sh_degree=min(args.sh_degree, 2),
                                     device=dev)
        with torch.no_grad():
            for f in frames:
                f.image = rasterize(gt, f.camera, render_cfg,
                                    impl=args.impl)["rgb"].cpu().numpy()
        train_frames, eval_frames = train_eval_split(frames, args.eval_every)
        pts = gt.means[gt.alive].cpu().numpy()
        init = Gaussians.from_points(
            pts + np.random.default_rng(0).normal(scale=0.02, size=pts.shape
                                                  ).astype(np.float32),
            sh_degree=args.sh_degree, capacity=args.capacity, device=dev)
    elif args.colmap:
        from robosimgs_tpu_torch.utils.colmap import load_colmap
        frames, sfm_xyz, sfm_rgb = load_colmap(args.colmap, args.images,
                                               downscale=args.downscale,
                                               device=dev)
        train_frames, eval_frames = train_eval_split(frames, args.eval_every)
        if not len(sfm_xyz):
            raise SystemExit("COLMAP model has no points3D.bin to init from")
        init = Gaussians.from_points(sfm_xyz, sfm_rgb,
                                     sh_degree=args.sh_degree,
                                     capacity=args.capacity, device=dev)
    else:
        if not args.data:
            raise SystemExit("one of --data, --colmap or --synthetic is required")
        frames = parse_transforms_json(args.data, downscale=args.downscale,
                                       device=dev)
        train_frames, eval_frames = train_eval_split(frames, args.eval_every)
        # init from random points in the camera bounding volume
        centers = np.stack([f.camera.origin.cpu().numpy() for f in frames])
        lo, hi = centers.min(0), centers.max(0)
        extent = float(np.linalg.norm(hi - lo)) or 1.0
        rng = np.random.default_rng(0)
        n0 = min(args.capacity // 4, 100_000)
        pts = rng.uniform(lo - 0.2 * extent, hi + 0.2 * extent,
                          (n0, 3)).astype(np.float32)
        init = Gaussians.from_points(pts, sh_degree=args.sh_degree,
                                     capacity=args.capacity, device=dev)

    scene_extent = (args.scene_extent if args.scene_extent is not None
                    else camera_extent(frames))
    print(f"scene extent: {scene_extent:.3f}")

    densify = DensifyConfig()
    if args.grad_threshold is not None:
        densify = dataclasses.replace(densify,
                                      grad_threshold=args.grad_threshold)
    elif args.absgrad:
        # gsplat convention: absolute-value sums need ~4x the signed
        # threshold (no sign cancellation)
        densify = dataclasses.replace(
            densify, grad_threshold=densify.grad_threshold * 4)
    cfg = TrainConfig(
        iterations=args.iterations,
        render=render_cfg,
        impl=args.impl,
        background=tuple(args.background),
        checkpoint_dir=os.path.abspath(os.path.join(args.output, "checkpoints")),
        checkpoint_every=args.checkpoint_every,
        scene_extent=scene_extent,
        densify=densify,
        scale_reg_lambda=args.scale_reg,
        exposure=args.exposure,
        bilateral_grid=args.bilateral_grid,
    )

    trainer = Trainer(cfg, init, train_frames, eval_frames)
    if args.trace:
        prof = traced_run(trainer, args.trace)
        print(f"trace {prof.trace_path}, spans {prof.summary_path}")
        print(f"counters {json.dumps(prof.summary['counters'])}")
    else:
        trainer.run()
    metrics = trainer.eval_metrics()
    print(f"final eval PSNR: {metrics['psnr']:.2f} dB  "
          f"SSIM: {metrics['ssim']:.4f}")

    ply_path = os.path.join(args.output, "scene.ply")
    save_ply(ply_path, trainer.state.gaussians)
    with open(os.path.join(args.output, "train_summary.json"), "w") as fh:
        json.dump({"psnr": metrics["psnr"], "ssim": metrics["ssim"],
                   "history": trainer.history,
                   "n_alive": int(trainer.state.gaussians.num_alive)}, fh,
                  indent=2)
    print(f"saved {ply_path}")


def traced_run(trainer, log_dir: str):
    """trainer.run() under utils.profiling.trace(log_dir); returns the
    profiler. A run that logs three times or more records the steps
    after its second logged step up to its third (the first interval
    holds the first steps' allocations), so that the trace and the span
    records keep one interval's size however long the run; a shorter run
    is recorded whole."""
    import torch

    from robosimgs_tpu_torch.utils.profiling import trace
    cfg = trainer.cfg
    window = None
    if cfg.iterations > 2 * cfg.log_every:
        # a profiler step at every logged step: waits to the first,
        # warms up to the second, records to the third
        window = torch.profiler.schedule(wait=1, warmup=1, active=1,
                                         repeat=1)
    with trace(log_dir, schedule=window) as prof:
        trainer.run(on_log=(lambda m: prof.step()) if window else None)
    return prof


if __name__ == "__main__":
    main()
