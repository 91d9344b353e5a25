"""The flagship reconstruction: a textured 48-camera capture at 512x512,
trained into a 500,000-slot pool from 20,000 noisy surface samples.

    python -m robosimgs_tpu_torch.tools.flagship [out_dir] [--iters 6000]
        [--res 512] [--capacity 500000] [--init 20000] [--views 48]
        [--holdout 6] [--grad-thresh 1.5e-4] [--densify-interval 120]
        [--device cuda]

A port of the JAX package's scripts/train_synthetic_flagship.py, with
its parameters, numpy seeds and output keys. The scene is a floor of
8x8 plates and 40 boxes, every face its own shade of its part's base
colour (detail that only densification can fit). The cameras sit on two
rings looking down at it, and the targets are the port's mesh
rasterizer's renders on white, asserted free of truncated triangles
and overflowed tiles (one full-extent floor triangle once covered more
tiles than a triangle may list, and the floor went missing from the
targets). Training starts from the surface samples with 1 cm of noise
(the stand-in for an SfM cloud), densifies from step 400 to 0.7 of the
run every 120 steps, never resets the opacities, keeps the whole pool
(no dynamic resize) and holds out 6 of the 48 views.

Writes <out_dir>/result.json (train and held-out PSNR, it/s, the final
alive count and the whole log history, each entry with its `overflow`:
the tiles past K = 2,048 plus the truncated Gaussians) and four PNGs
(render and target of the first held-out and the first training view).
The densify splits draw from a torch.Generator, so a run follows its own
trajectory, not the JAX package's, from the first densify round on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from robosimgs_tpu_torch.cli.render import write_png
from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.core.types import Gaussians
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.mesh_raster import (MeshRasterConfig,
                                                    rasterize_mesh)
from robosimgs_tpu_torch.render.rasterize import rasterize
from robosimgs_tpu_torch.tools import workloads
from robosimgs_tpu_torch.train.data import Frame
from robosimgs_tpu_torch.train.densify import DensifyConfig
from robosimgs_tpu_torch.train.optim import OptimConfig
from robosimgs_tpu_torch.train.trainer import TrainConfig, Trainer
from robosimgs_tpu_torch.utils.meshio import Mesh, concatenate

# the targets' mesh capacities: a floor plate covers up to ~100 tiles
TARGET_MESH = MeshRasterConfig(tile_capacity=1024, max_tiles_per_tri=256)


def box(center, size) -> Mesh:
    """An axis-aligned box of half-extents `size` at `center`."""
    sx, sy, sz = size
    v = np.array([[x, y, z] for x in (-sx, sx) for y in (-sy, sy)
                  for z in (-sz, sz)], np.float32) + np.asarray(center,
                                                                np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return Mesh(v, f)


def scene_mesh(seed: int):
    """(mesh, face colours): the 8x8 floor plates, then 40 boxes, drawn
    from np.random.default_rng(seed) in the JAX script's order."""
    rng = np.random.default_rng(seed)
    parts = []
    for gx in range(8):
        for gy in range(8):
            cx = -1.3 + (2 * gx + 1) * 1.3 / 8
            cy = -1.3 + (2 * gy + 1) * 1.3 / 8
            parts.append(box((cx, cy, -0.55), (1.3 / 8, 1.3 / 8, 0.05)))
    n_floor = len(parts)
    for _ in range(40):
        center = rng.uniform(-0.85, 0.85, 3) * np.array([1, 1, 0.35])
        size = rng.uniform(0.05, 0.22, 3)
        parts.append(box(center, size))
    scene = concatenate(parts)
    # each face its own shade of its part's base colour
    fc = []
    floor_base = rng.uniform(0.3, 0.8, 3)
    for i, p in enumerate(parts):
        base = floor_base if i < n_floor else rng.uniform(0.15, 0.95, 3)
        n = p.faces.shape[0]
        fc.append(np.clip(base[None] * rng.uniform(0.45, 1.0, (n, 1)), 0, 1))
    return scene, np.concatenate(fc).astype(np.float32)


def ring_camera(i: int, n_cameras: int, res: int, device="cuda") -> Camera:
    """Camera i of two interleaved rings (elevations 1.5 and 2.6, the
    second turned 0.21 rad), both looking down at the scene: grazing
    views alone leave the thin floor unreconstructable."""
    ring = i % 2
    ang = 2 * np.pi * (i // 2) / (n_cameras // 2) + ring * 0.21
    el = (1.5, 2.6)[ring]
    eye = [2.6 * np.cos(ang), 2.6 * np.sin(ang), el]
    return Camera.look_at(eye, [0, 0, -0.1], [0, 0, 1], 55.0, res, res,
                          device=device)


def build_scene(seed: int, n_cameras: int, res: int, with_depth: bool = False,
                device="cuda"):
    """(mesh, frames): the scene and its n_cameras targets, rendered on
    `device` by the mesh rasterizer; white where no face is hit.
    with_depth attaches the z-buffer (0 where no face is hit) for depth
    supervision."""
    scene, face_colors = scene_mesh(seed)
    verts = torch.from_numpy(scene.vertices).to(device)
    faces = torch.from_numpy(scene.faces).to(device)
    fcol = torch.from_numpy(face_colors).to(device)
    frames = []
    for i in range(n_cameras):
        cam = ring_camera(i, n_cameras, res, device)
        out = rasterize_mesh(verts, faces, cam, face_colors=fcol,
                             cfg=TARGET_MESH)
        st = out["stats"]
        trunc, over = int(st.truncated_gaussians), int(st.overflowed_tiles)
        assert trunc == 0 and over == 0, (
            f"target render truncated (cam {i}): {trunc} triangles, {over} "
            "tiles — raise the MeshRasterConfig capacities")
        mask = out["mask"].cpu().numpy()
        img = np.where(mask[..., None], out["rgb"].cpu().numpy(),
                       1.0).astype(np.float32)
        dep = None
        if with_depth:
            dep = np.where(mask, out["depth"].cpu().numpy(),
                           0.0).astype(np.float32)
        frames.append(Frame(camera=cam, image=img, depth=dep))
    return scene, frames


def holdout_split(frames, n_hold: int):
    """(train, eval): n_hold views spread evenly by np.linspace."""
    n = len(frames)
    hold = set(np.linspace(0, n - 1, n_hold).astype(int).tolist())
    return ([f for i, f in enumerate(frames) if i not in hold],
            [f for i, f in enumerate(frames) if i in hold])


def init_points(scene: Mesh, n_init: int) -> np.ndarray:
    """Surface samples (seed 1) plus N(0, 1 cm) noise from
    np.random.default_rng(0)."""
    rng = np.random.default_rng(0)
    pts = scene.sample_surface(n_init, seed=1)
    pts = pts + rng.normal(scale=0.01, size=pts.shape).astype(np.float32)
    return pts.astype(np.float32)


def train_config(iters: int, grad_thresh: float = 1.5e-4,
                 densify_interval: int = 120) -> TrainConfig:
    """The flagship's schedule: K 2,048, white background, extent 3,
    densify from 400 to 0.7 iters, no opacity reset, the whole pool."""
    return TrainConfig(
        iterations=iters,
        render=RenderConfig(tile_capacity=2048),
        impl="auto",
        background=(1.0, 1.0, 1.0),
        scene_extent=3.0,
        optim=OptimConfig(means_lr_max_steps=iters),
        densify=DensifyConfig(grad_threshold=grad_thresh),
        densify_from=400,
        densify_until=int(0.7 * iters),
        densify_interval=densify_interval,
        # white background + a thin floor seen partly at grazing angles
        # never recover from an opacity reset's clamp
        opacity_reset_interval=10_000,
        dynamic_pool=False,
        log_every=100,
    )


def make_trainer(res: int = 512, iters: int = 6000, capacity: int = 500_000,
                 n_init: int = 20_000, n_views: int = 48, n_hold: int = 6,
                 grad_thresh: float = 1.5e-4, densify_interval: int = 120,
                 device="cuda", frames=None, scene=None):
    """(trainer, n_init points): the scene (unless given), its split, the
    initial pool and the flagship's TrainConfig."""
    if frames is None:
        scene, frames = build_scene(11, n_views, res, device=device)
    train_frames, eval_frames = holdout_split(frames, n_hold)
    pts = init_points(scene, n_init)
    init = Gaussians.from_points(pts, sh_degree=2, capacity=capacity,
                                 device=device)
    cfg = train_config(iters, grad_thresh, densify_interval)
    return Trainer(cfg, init, train_frames, eval_frames=eval_frames), len(pts)


def run(out_dir: str, res: int = 512, iters: int = 6000,
        capacity: int = 500_000, n_init: int = 20_000, n_views: int = 48,
        n_hold: int = 6, grad_thresh: float = 1.5e-4,
        densify_interval: int = 120, device="cuda",
        progress: bool = True) -> dict:
    """Train the flagship and write result.json and the PNGs into
    out_dir; returns result.json's dict."""
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device(device)
    scene, frames = build_scene(11, n_views, res, device=dev)
    trainer, n_pts = make_trainer(res, iters, capacity, n_init, n_views,
                                  n_hold, grad_thresh, densify_interval,
                                  dev, frames, scene)
    if progress:
        print(f"{len(trainer.frames)} train views, "
              f"{len(trainer.eval_frames)} held out, {res}x{res}; init "
              f"{n_pts} pts, capacity {capacity}, iters {iters}", flush=True)
    t0 = time.time()
    trainer.run(progress=progress)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0

    train_psnr = trainer.history[-1]["psnr"]
    eval_psnr = trainer.eval_psnr()
    alive = int(trainer.state.gaussians.num_alive)
    if progress:
        peak = (f" peak_memory={torch.cuda.max_memory_allocated(dev)} B"
                if dev.type == "cuda" else "")
        print(f"RESULT iters={iters} ({iters / dt:.1f} it/s) "
              f"train_psnr={train_psnr:.2f} eval_psnr={eval_psnr:.2f} "
              f"alive={alive}{peak}", flush=True)
    bg = torch.ones(3, device=dev)
    with torch.no_grad():
        for tag, fr in (("eval", trainer.eval_frames[0]),
                        ("train0", trainer.frames[0])):
            out = rasterize(trainer.state.gaussians, fr.camera.to(dev),
                            trainer.cfg.render, background=bg, impl="auto")
            img = np.clip(out["rgb"].cpu().numpy(), 0, 1)
            write_png(os.path.join(out_dir, f"render_{tag}.png"),
                      (img * 255).astype(np.uint8))
            write_png(os.path.join(out_dir, f"target_{tag}.png"),
                      (np.clip(fr.image, 0, 1) * 255).astype(np.uint8))
    result = {"train_psnr": float(train_psnr), "eval_psnr": float(eval_psnr),
              "iters_per_sec": iters / dt, "iterations": iters,
              "views": len(trainer.frames), "capacity": capacity,
              "init_points": n_pts, "final_alive": alive,
              "resolution": [res, res], "history": trainer.history}
    with open(os.path.join(out_dir, "result.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    if progress:
        print(f"artifacts in {out_dir}", flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", nargs="?", default="flagship_out")
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--iters", type=int, default=6000)
    ap.add_argument("--capacity", type=int, default=500_000)
    ap.add_argument("--init", type=int, default=20_000)
    ap.add_argument("--views", type=int, default=48)
    ap.add_argument("--holdout", type=int, default=6)
    ap.add_argument("--grad-thresh", type=float, default=1.5e-4)
    ap.add_argument("--densify-interval", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if workloads.open_device(args.device, "flagship") is None:
        return 1
    run(args.out_dir, res=args.res, iters=args.iters, capacity=args.capacity,
        n_init=args.init, n_views=args.views, n_hold=args.holdout,
        grad_thresh=args.grad_thresh,
        densify_interval=args.densify_interval, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
