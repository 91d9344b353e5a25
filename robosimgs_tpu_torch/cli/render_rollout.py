"""Rollout rendering CLI: trained scene + URDF objects + trajectory ->
multi-camera frames (the data-generation render stage).

The port of robosimgs_tpu/cli/render_rollout.py, with the same flags
plus `--device` (default cuda). Frames are written as 8-bit PNGs
(frame_TTTT_camC.png) by cli/render.py's writer. Unlike the JAX CLI,
which keeps the mesh rasterizer's default tile capacity whatever the
meshes, `--autotune` also sizes the mesh tile capacity from the measured
triangle demand (render/autotune.py::mesh_demand); without it the
capacity stays the default and any overflowed mesh tiles or truncated
triangles are reported on stderr.

    python -m robosimgs_tpu_torch.cli.render_rollout --scene scene.ply \\
        --urdf object.urdf --steps 16 --n-cameras 4 --autotune --output frames

--shard-cameras shards the cameras over the ranks torchrun starts (its
environment: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT; one rank
without a launcher), NCCL on CUDA devices (rank r on card LOCAL_RANK)
and gloo on the CPU; the largest rank count that divides the cameras
renders, the other ranks wait, and rank 0 writes the frames:

    torchrun --nproc-per-node=4 -m robosimgs_tpu_torch.cli.render_rollout \\
        --scene scene.ply --urdf object.urdf --shard-cameras --output frames
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys


def build_parser():
    p = argparse.ArgumentParser(
        description="Render multi-camera rollout frames")
    p.add_argument("--scene", required=True, help="background .ply (3DGS)")
    p.add_argument("--urdf", action="append", default=[],
                   help="articulated object URDF (repeatable)")
    p.add_argument("--trajectory", default=None,
                   help="npy/json (T, dof) joint trajectory; default: "
                        "open-close sweep")
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--cameras", default=None,
                   help="json list of {eye, target, up, fov, width, height}")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--n-cameras", type=int, default=4)
    p.add_argument("--output", required=True, help="output dir (png frames)")
    p.add_argument("--impl", default="auto")
    p.add_argument("--shard-cameras", action="store_true",
                   help="shard the cameras over torchrun's ranks")
    p.add_argument("--autotune", action="store_true",
                   help="measure the scene and the posed meshes against "
                        "the rollout cameras and render with lossless-fit "
                        "capacities (splat and mesh tiles) + the two-tier "
                        "sort")
    p.add_argument("--autotune-gate-db", type=float, default=60.0,
                   help="with --autotune: shrink tile_capacity to the "
                        "smallest K whose render matches the full-"
                        "demand capacity above this PSNR (saturation "
                        "gate; 0 disables and keeps the lossless K)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: cuda)")
    p.add_argument("--trace", metavar="DIR", default=None,
                   help="profile the render: write its Chrome trace and "
                        "span summary (utils/profiling.py) to DIR and print "
                        "the counters, truncated splats and triangles "
                        "among them")
    return p


def _join_ranks(device: str):
    """(rank, world, device of this rank, whether this call made the
    process group) from torchrun's environment."""
    import torch
    import torch.distributed as dist
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
        device = f"cuda:{torch.cuda.current_device()}"
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), device, False
    backend = "nccl" if cuda else "gloo"
    if world > 1:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return rank, world, device, True


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.shard_cameras:
        _run(args, 0, 1)
        return
    import torch.distributed as dist
    rank, world, args.device, made_group = _join_ranks(args.device)
    try:
        _run(args, rank, world)
        dist.barrier()        # ranks outside the camera mesh wait here
    finally:
        if made_group:
            dist.destroy_process_group()


def _run(args, rank: int, world: int):
    import numpy as np

    from robosimgs_tpu_torch.cli.render import write_png
    from robosimgs_tpu_torch.core.camera import Camera
    from robosimgs_tpu_torch.render.autotune import (mesh_demand,
                                                     mesh_tile_capacity,
                                                     recommend_capacities)
    from robosimgs_tpu_torch.render.mesh_raster import MeshRasterConfig
    from robosimgs_tpu_torch.scenegen.rollout import (ArticulatedObject,
                                                      open_close_trajectory,
                                                      render_rollout,
                                                      rollout_meshes)
    from robosimgs_tpu_torch.train.io_ply import load_ply
    from robosimgs_tpu_torch.utils.profiling import trace

    background = load_ply(args.scene, device=args.device)
    objects = [ArticulatedObject.from_urdf(u) for u in args.urdf]

    cams = []
    if args.cameras:
        with open(args.cameras) as fh:
            specs = json.load(fh)
        for c in specs:
            cams.append(Camera.look_at(
                c["eye"], c["target"], c.get("up", [0, 0, 1]),
                c.get("fov", 60.0), c.get("width", args.width),
                c.get("height", args.height), device=args.device))
    else:
        for i in range(args.n_cameras):
            ang = 2 * np.pi * i / args.n_cameras
            cams.append(Camera.look_at(
                [2.5 * np.cos(ang), 2.5 * np.sin(ang), 1.5], [0, 0, 0.3],
                [0, 0, 1], 60.0, args.width, args.height, device=args.device))

    base_poses = None
    if args.trajectory:
        if args.trajectory.endswith(".npy"):
            traj = np.load(args.trajectory)
        else:
            with open(args.trajectory) as fh:
                loaded = json.load(fh)
            if isinstance(loaded, dict) and "steps" in loaded:
                from robosimgs_tpu_torch.scenegen.trajectory import \
                    load_trajectory
                traj, base_poses = load_trajectory(
                    args.trajectory, [o.model for o in objects])
            else:
                traj = np.asarray(loaded, np.float32)
    elif objects:
        trajs = [open_close_trajectory(o.model, args.steps) for o in objects]
        traj = np.concatenate(trajs, axis=1)
    else:
        traj = np.zeros((args.steps, 0), np.float32)

    camera_mesh = None
    if args.shard_cameras:
        from robosimgs_tpu_torch.parallel.mesh import make_mesh
        n_data = min(world, len(cams))
        while len(cams) % n_data:
            n_data -= 1             # the camera count must tile the axis
        camera_mesh = make_mesh(n_data, 1,
                                device_type=args.device.split(":")[0])
        if rank == 0:
            print(f"sharding {len(cams)} cameras over {n_data} devices")
        if camera_mesh.get_coordinate() is None:
            return                  # this rank waits in main's barrier

    kw = {}
    mesh_cfg = MeshRasterConfig()
    demand = None
    if objects:
        # the mesh binning's demand over every (step, camera, link): sizes
        # the tile capacity under --autotune, and is reported otherwise
        demand = mesh_demand(rollout_meshes(objects, traj, base_poses,
                                            args.device), cams, mesh_cfg)
    if args.autotune:
        rcfg = recommend_capacities(background, cams,
                                    gate_db=args.autotune_gate_db or None)
        line = (f"autotuned: K={rcfg.tile_capacity} "
                f"M={rcfg.max_tiles_per_gaussian} "
                f"bbox={rcfg.bbox_tiles_per_gaussian} "
                f"two_tier={rcfg.two_tier_split}")
        kw["cfg"] = rcfg
        if demand is not None:
            mesh_cfg = dataclasses.replace(mesh_cfg, tile_capacity=(
                mesh_tile_capacity(demand["max_tile_count"])))
            # the capacity holds the largest tile: none overflows
            demand["overflowed_tiles"] = 0
            line += (f" mesh_K={mesh_cfg.tile_capacity} (max triangles a "
                     f"tile {demand['max_tile_count']})")
        if rank == 0:
            print(line)
    if rank == 0 and demand and (demand["overflowed_tiles"]
                                 or demand["truncated_triangles"]):
        print(f"render_rollout: mesh binning at tile capacity "
              f"{mesh_cfg.tile_capacity} drops triangles: "
              f"{demand['overflowed_tiles']} overflowed tiles (up to "
              f"{demand['max_tile_count']} triangles a tile), "
              f"{demand['truncated_triangles']} truncated triangles, summed "
              f"over steps, cameras and links (--autotune sizes the tile "
              f"capacity)", file=sys.stderr)

    with (trace(args.trace) if args.trace
          else contextlib.nullcontext()) as prof:
        frames = render_rollout(background, objects, traj, cams,
                                impl=args.impl, base_poses=base_poses,
                                as_uint8=True, mesh_cfg=mesh_cfg,
                                camera_mesh=camera_mesh, **kw)
    if args.trace:
        print(f"trace {prof.trace_path}, spans {prof.summary_path}")
        print(f"counters {json.dumps(prof.summary['counters'])}")
    if rank:
        return
    os.makedirs(args.output, exist_ok=True)
    T, C = frames.shape[:2]
    for t in range(T):
        for c in range(C):
            write_png(os.path.join(args.output, f"frame_{t:04d}_cam{c}.png"),
                      frames[t, c])
    print(f"wrote {T * C} frames to {args.output}")


if __name__ == "__main__":
    main()
