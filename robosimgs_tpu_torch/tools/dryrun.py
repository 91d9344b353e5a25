"""One sharded step of every multi-device path on N ranks (the port's
counterpart of the JAX package's __graft_entry__.dryrun_multichip).

    python -m robosimgs_tpu_torch.tools.dryrun 4 --device cpu

On N spawned ranks (tools/dist_run.py; gloo on the CPU, NCCL on N cards):
the DP step over cameras x tile rows, the gaussian-sharded step, the
ring step, the camera-sharded rollout, sharded densify then compaction
then a step at the new capacity, and the ring at 65,536 Gaussians on a
(N, 1) mesh; tiny shapes otherwise. Rank 0 prints one summary line.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from robosimgs_tpu_torch.core.convert import shard_train_state
from robosimgs_tpu_torch.core.types import Gaussians
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.rasterize import rasterize
from robosimgs_tpu_torch.train.densify import DensifyState
from robosimgs_tpu_torch.train.optim import float_params, make_optimizer
from robosimgs_tpu_torch.train.trainer import TrainConfig, TrainState


def _state(seed: int, n: int, optimizer, device, **kw) -> TrainState:
    g = Gaussians.random(torch.Generator().manual_seed(seed), n,
                         sh_degree=1, device=device, **kw)
    return TrainState(gaussians=g, opt_state=optimizer.init(float_params(g)),
                      densify_state=DensifyState.zero(n, device=device),
                      step=0, generator=torch.Generator().manual_seed(0))


def _finite(name: str, x) -> float:
    x = float(x)
    if not np.isfinite(x):
        raise AssertionError(f"non-finite {name} {x}")
    return x


def dryrun_rank(rank, world, device):
    from robosimgs_tpu_torch.parallel.distributed import (
        make_dp_train_step, make_gaussian_sharded_train_step,
        make_sharded_compact, make_sharded_densify_step, sharded_pool_target,
        stack_cameras)
    from robosimgs_tpu_torch.parallel.mesh import axis_size, make_mesh
    from robosimgs_tpu_torch.scenegen.rollout import render_rollout
    from robosimgs_tpu_torch.train.data import synthetic_scene

    dev = torch.device(device)
    dtype = dev.type
    n_tile = 2 if world % 2 == 0 else 1
    n_data = world // n_tile
    mesh = make_mesh(n_data, n_tile, device_type=dtype)
    d_rank = mesh.get_local_rank("data")
    cfg = TrainConfig(render=RenderConfig(tile_capacity=128,
                                          ref_gaussian_chunk=64),
                      scene_extent=1.0)
    impl = "tiled" if dtype == "cuda" else "reference"
    gt, frames = synthetic_scene(0, 32, n_data, 32, 32, sh_degree=1,
                                 device=dev)
    targets = torch.stack([rasterize(gt, f.camera, cfg.render,
                                     impl="reference")["rgb"]
                           for f in frames])
    optimizer = make_optimizer(cfg.optim, cfg.scene_extent)

    # 1) DP over cameras x tile-sharded rasterization
    state, m = make_dp_train_step(cfg, mesh, impl=impl)(
        _state(1, 32, optimizer, dev), stack_cameras([f.camera
                                                      for f in frames]),
        targets)
    loss = _finite("dp loss", m["loss"])
    assert state.step == 1
    # 2) gaussian-sharded parameters x tile rows
    gs_step = make_gaussian_sharded_train_step(cfg, mesh, impl=impl)
    state2, m2 = gs_step(
        shard_train_state(_state(2, 32, optimizer, dev), n_data, d_rank),
        frames[0].camera, targets[0])
    loss2 = _finite("sharded-gaussian loss", m2["loss"])
    # 3) the ring (tiled impl: it emits pre-gathered tile blocks)
    _, m3 = make_gaussian_sharded_train_step(
        cfg, mesh, impl="tiled", gather="ring")(
        shard_train_state(_state(3, 32, optimizer, dev), n_data, d_rank),
        frames[0].camera, targets[0])
    loss3 = _finite("ring-sharded loss", m3["loss"])
    # 4) camera-sharded rollout (cameras over 'data', replicated scene)
    roll = render_rollout(Gaussians.random(torch.Generator().manual_seed(4),
                                           32, sh_degree=1, device=dev),
                          [], np.zeros((1, 0), np.float32),
                          [f.camera for f in frames], cfg=cfg.render,
                          impl=impl, camera_mesh=mesh)
    assert roll.shape[:2] == (1, n_data) and np.isfinite(roll).all()
    # 5) densify / prune then compaction under the sharded pool, then a
    # step at the new capacity
    local = state2.gaussians.capacity
    alive = torch.ones((local,), dtype=torch.bool, device=dev)
    alive[(3 * local) // 4:] = False
    state5 = dataclasses.replace(
        state2, gaussians=state2.gaussians.replace(alive=alive),
        densify_state=DensifyState(
            grad_accum=torch.ones((local,), device=dev),
            count=torch.ones((local,), dtype=torch.int32, device=dev),
            max_radii=state2.densify_state.max_radii))
    state5, info = make_sharded_densify_step(cfg, mesh)(state5, False)
    spawned = int(info["spawned"])
    local_cap = sharded_pool_target(state5, mesh, headroom=1.0, bucket=8,
                                    local_max=64)
    state5 = make_sharded_compact(mesh)(state5, local_cap)
    _, m5 = gs_step(state5, frames[0].camera, targets[0])
    loss5 = _finite("post-densify loss", m5["loss"])
    assert state5.gaussians.capacity == local_cap
    # 6) the ring at 65,536 Gaussians over a (world, 1) mesh: real
    # per-shard binning and sort sizes, a small carried (T, K) buffer
    mesh6 = make_mesh(world, 1, device_type=dtype)
    cfg6 = TrainConfig(render=RenderConfig(tile_capacity=256,
                                           max_tiles_per_gaussian=12),
                       scene_extent=1.0)
    big = _state(6, 65_536, optimizer, dev, extent=1.5)
    cam6 = dataclasses.replace(frames[0].camera, width=64, height=64,
                               cx=torch.tensor(32.0, device=dev),
                               cy=torch.tensor(32.0, device=dev))
    _, m6 = make_gaussian_sharded_train_step(
        cfg6, mesh6, impl="tiled", gather="ring")(
        shard_train_state(big, world, mesh6.get_local_rank("data")), cam6,
        torch.zeros((64, 64, 3), device=dev))
    loss6 = _finite("big-ring loss", m6["loss"])
    line = (f"dryrun_multichip({world}): mesh=({n_data}x{n_tile}) "
            f"dp_loss={loss:.5f} gauss_sharded_loss={loss2:.5f} "
            f"ring_loss={loss3:.5f} rollout_cams={axis_size(mesh, 'data')} "
            f"densify_spawned={spawned} post_densify_loss={loss5:.5f} "
            f"ring64k_loss={loss6:.5f} ok")
    if rank == 0:
        print(line, flush=True)
    return line


def dryrun_multichip(n_devices: int, device: str = "cuda") -> str:
    """Run every sharded path once on n_devices ranks (NCCL, one card a
    rank, for "cuda"; gloo for "cpu"); returns the summary line."""
    from robosimgs_tpu_torch.tools.dist_run import run_ranks
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    return run_ranks(dryrun_rank, n_devices, backend=backend,
                     device=device)[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n_devices", type=int)
    p.add_argument("--device", default="cuda",
                   help="cuda (one card a rank, NCCL) or cpu (gloo)")
    args = p.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
