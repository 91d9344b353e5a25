"""Multi-process rehearsal: 8 ranks joined over TCP run the DP train
step on a (data 2, tile 4) mesh, and every rank's loss must equal one
process's.

    python -m robosimgs_tpu_torch.tools.multihost_rehearsal [--device cuda]

A port of the JAX package's scripts/multihost_rehearsal.py. Its 2
processes x 4 virtual devices are 8 ranks (tools/dist_run.py::run_ranks,
`multihost_dp`) joined by parallel/mesh.py::initialize_multihost over
tcp://127.0.0.1:<a free port>, on a (data = 2, tile = 4) mesh with data
outermost, as make_mesh orders ranks: the data row of rank r is r // 4,
so the gradient all-reduce over 'data' crosses the rows (the script's
process boundary) and the row gather of 'tile' stays inside one.

`build_problem` is the script's scene through the port: synthetic_scene
seed 0, 40 Gaussians, 4 cameras at 32x32, SH 1, the targets rendered by
the reference compositor, the initial pool drawn from a generator
seeded 7, K 128, impl "reference" (the torch.Generator draws differ
from the JAX keys'). `rehearse` runs STEPS make_dp_train_step steps on
every rank and the same steps at world 1 in this process (mesh (1, 1)),
and holds each rank's last loss to it within 1e-5 relative (the
script's bound); every rank must report the same loss.

The backend is gloo unless the card count covers the ranks (NCCL takes
one rank a card). Prints the script's `MULTIHOST_LOSS` lines and a
`RESULT {json}`; exits 2 when a loss differs.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from robosimgs_tpu_torch.core.types import Gaussians
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.rasterize import rasterize
from robosimgs_tpu_torch.tools import dist_run, workloads
from robosimgs_tpu_torch.train.data import synthetic_scene
from robosimgs_tpu_torch.train.densify import DensifyState
from robosimgs_tpu_torch.train.optim import float_params, make_optimizer
from robosimgs_tpu_torch.train.trainer import TrainConfig, TrainState

N_PROC = 2
LOCAL_DEVS = 4
STEPS = 2
RTOL = 1e-5


def train_config() -> TrainConfig:
    return TrainConfig(render=RenderConfig(tile_capacity=128,
                                           ref_gaussian_chunk=64),
                       scene_extent=1.0, impl="reference")


def build_problem(device="cpu"):
    """(TrainConfig, [Camera] x 4, targets (4, 32, 32, 3) numpy, the
    initial TrainState): the script's scene on `device`."""
    cfg = train_config()
    gt, frames = synthetic_scene(seed=0, n_gaussians=40, n_cameras=4,
                                 width=32, height=32, sh_degree=1,
                                 device=device)
    with torch.no_grad():
        targets = np.stack([rasterize(gt, f.camera, cfg.render,
                                      impl="reference")["rgb"].cpu().numpy()
                            for f in frames])
    init = Gaussians.random(torch.Generator().manual_seed(7), 40,
                            sh_degree=1, device=device)
    optimizer = make_optimizer(cfg.optim, cfg.scene_extent)
    state = TrainState(gaussians=init,
                       opt_state=optimizer.init(float_params(init)),
                       densify_state=DensifyState.zero(init.capacity,
                                                       device=device),
                       step=0, generator=torch.Generator().manual_seed(0))
    return cfg, [f.camera for f in frames], targets, state


def single_process_loss(cfg, cams, targets, state, device,
                        steps: int = STEPS) -> float:
    """The last loss of `steps` DP steps at world 1 (mesh (1, 1), a gloo
    group of this process alone unless one exists)."""
    own = not dist.is_initialized()
    if own:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{dist_run.free_port()}",
            world_size=1, rank=0)
    try:
        return float(dist_run.dp_step(0, 1, device, (1, 1), cfg,
                                      "reference", state, cams, targets,
                                      steps=steps)["loss"])
    finally:
        if own:
            dist.destroy_process_group()


def default_backend(device, world: int) -> str:
    if torch.device(device).type == "cuda" \
            and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rehearse(cfg, cams, targets, state, device="cuda",
             steps: int = STEPS) -> dict:
    """`steps` DP steps on N_PROC x LOCAL_DEVS ranks joined by
    initialize_multihost, mesh (N_PROC, LOCAL_DEVS), and at world 1
    here: {"losses": each rank's last loss, "coordinates", "launches",
    "single_process_loss", "match", ...}. Inputs on the CPU (each rank
    moves them to `device`)."""
    world, mesh_shape = N_PROC * LOCAL_DEVS, (N_PROC, LOCAL_DEVS)
    backend = default_backend(device, world)
    cpu = torch.device("cpu")
    kw = dict(mesh_shape=mesh_shape, cfg=cfg, impl="reference",
              state=dist_run._to(state, cpu),
              cams=[c.to(cpu) for c in cams], targets=np.asarray(targets),
              steps=steps)
    ranks = dist_run.run_ranks(
        dist_run.multihost_dp, world, backend=None, device=device,
        args=(f"127.0.0.1:{dist_run.free_port()}", kw, backend))
    ref = single_process_loss(cfg, cams, targets, state, device, steps)
    losses = [float(r["loss"]) for r in ranks]
    coords = [list(r["coordinate"]) for r in ranks]
    rows_ok = coords == [[r // LOCAL_DEVS, r % LOCAL_DEVS]
                         for r in range(world)]
    match = (max(losses) - min(losses) <= 1e-12 and all(
        abs(x - ref) < RTOL * max(1.0, abs(ref)) for x in losses))
    return {"multihost_loss": losses[0], "single_process_loss": ref,
            "losses": losses, "coordinates": coords,
            "data_rows_outermost": rows_ok,
            "launches": [list(r["launches"]) for r in ranks],
            "processes": world, "mesh": list(mesh_shape),
            "backend": backend, "steps": steps,
            "match": bool(match and rows_ok)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = workloads.open_device(args.device, "multihost_rehearsal")
    if dev is None:
        return 1
    cfg, cams, targets, state = build_problem("cpu")
    res = rehearse(cfg, cams, targets, state, args.device)
    for r, loss in enumerate(res["losses"]):
        print(f"MULTIHOST_LOSS pid={r} procs={res['processes']} "
              f"mesh={tuple(res['mesh'])} coordinate="
              f"{tuple(res['coordinates'][r])} loss={loss:.8f}", flush=True)
    print(f"single-process reference loss={res['single_process_loss']:.8f}")
    print("RESULT " + json.dumps(res), flush=True)
    return 0 if res["match"] else 2


if __name__ == "__main__":
    sys.exit(main())
