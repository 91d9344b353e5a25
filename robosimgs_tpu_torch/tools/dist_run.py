"""Run a function on N ranks, and the rank cases the multi-rank tests and
chip_smoke.py's phase 12 share.

    results = run_ranks(run_cases, world=4, args=([("dp", dp_step, kw)],))

`run_ranks` spawns `world` processes (torch.multiprocessing, "spawn"),
each with one torch thread and torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT). With a backend it joins them in
one process group over a file:// store in a temporary directory (no
port to clash with other runs); with backend None the function
initializes the group itself (env:// or initialize_multihost). Each rank
calls fn(rank, world, device, *args); its result comes back through a
file as numpy (core/convert.py::to_numpy), one entry per rank. A rank
that raises fails the whole run: the others are stopped and the error
is raised here.

The cases live in the package, so that a spawned rank imports torch and
the port only. Each builds its mesh with every rank of the world, runs
one sharded path and returns what the caller compares; a rank outside
the case's mesh returns None.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import tempfile
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from robosimgs_tpu_torch.core.convert import gather_train_state, to_numpy
from robosimgs_tpu_torch.parallel import comm
from robosimgs_tpu_torch.parallel.distributed import (
    make_dp_train_step, make_gaussian_sharded_train_step,
    make_sharded_compact, make_sharded_densify_step, sharded_pool_target,
    stack_cameras)
from robosimgs_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
from robosimgs_tpu_torch.parallel.ring import (crop_camera_rows,
                                               ring_bin_gather,
                                               ring_render_rows)
from robosimgs_tpu_torch.train.optim import float_params

TIMEOUT = datetime.timedelta(seconds=600)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world, backend, device, tmp, port):
    # the arguments come by file, pickled by value: torch's own reducers
    # would share CPU tensors through descriptors the spawn refuses
    with open(os.path.join(tmp, "args.pkl"), "rb") as fh:
        args = pickle.load(fh)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if backend is not None:
        dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                                world_size=world, rank=rank, timeout=TIMEOUT)
    try:
        out = to_numpy(fn(rank, world, device, *args))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


def run_ranks(fn: Callable, world: int, backend: Optional[str] = "gloo",
              device: str = "cpu", args: Sequence = ()) -> list:
    """[fn(rank, world, device, *args) as numpy for rank in range(world)]
    from `world` spawned ranks (see the module docstring). fn and args
    must pickle by reference to the port (no JAX objects)."""
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "args.pkl"), "wb") as fh:
            pickle.dump(tuple(args), fh)
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world, backend, device, tmp, free_port()),
            nprocs=world, join=True, start_method="spawn")
        out = []
        for r in range(world):
            # written by the ranks of this call only
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
        return out


def run_cases(rank, world, device, cases):
    """{name: case(rank, world, device, **kw)} for (name, case, kw) in
    cases, in order (every rank runs every case: meshes are made
    collectively)."""
    return {name: case(rank, world, device, **kw) for name, case, kw in cases}


# -- the cases -------------------------------------------------------------


def _to(x, device):
    """Tensors of a dataclass / dict / list tree moved to device."""
    import dataclasses
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _to(getattr(x, f.name), device)
            for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, device) for v in x)
    return x


def _mesh(shape, device, ranks=None):
    return make_mesh(*shape, ranks=ranks,
                     device_type=torch.device(device).type)


class _Tally:
    """Kernel launches and comm calls / bytes made inside a with block."""

    def __enter__(self):
        from robosimgs_tpu_torch.render import kernels
        self._k = kernels
        self._launches = self._now()
        self._calls, self._bytes = dict(comm.COUNTS), dict(comm.BYTES)
        return self

    def _now(self):
        return (self._k.composite_fwd.launches,
                self._k.composite_bwd.launches)

    def __exit__(self, *exc):
        now = self._now()
        self.out = {
            "launches": (now[0] - self._launches[0],
                         now[1] - self._launches[1]),
            "comm_calls": {k: v - self._calls.get(k, 0)
                           for k, v in comm.COUNTS.items()
                           if v != self._calls.get(k, 0)},
            "comm_bytes": {k: v - self._bytes.get(k, 0)
                           for k, v in comm.BYTES.items()
                           if v != self._bytes.get(k, 0)}}
        return False


def dp_step(rank, world, device, mesh_shape, cfg, impl, state, cams, targets,
            ranks=None, steps=1):
    """`steps` make_dp_train_step(return_grads=True) steps: the last
    one's loss, psnr, n_alive and grads, the densify state, the
    compositing kernels' launches and comm's calls and bytes over the
    steps, and this rank's mesh coordinate (data, tile)."""
    mesh = _mesh(mesh_shape, device, ranks)
    if mesh.get_coordinate() is None:
        return None
    step = make_dp_train_step(cfg, mesh, impl=impl, return_grads=True)
    state, cams = _to(state, device), stack_cameras(_to(cams, device))
    targets = torch.as_tensor(np.asarray(targets), device=device)
    with _Tally() as tally:
        for _ in range(steps):
            state, m = step(state, cams, targets)
    return {**m, "step": state.step, "densify": state.densify_state,
            "coordinate": list(mesh.get_coordinate()), **tally.out}


def gs_step(rank, world, device, mesh_shape, cfg, impl, gather, shards,
            camera, target):
    """One make_gaussian_sharded_train_step(return_grads=True) step on
    this rank's shard (shards[data rank]): loss, psnr, n_alive, the local
    grads and densify state, launches and comm's calls and bytes."""
    mesh = _mesh(mesh_shape, device)
    step = make_gaussian_sharded_train_step(cfg, mesh, impl=impl,
                                            return_grads=True, gather=gather)
    state = _to(shards[mesh.get_local_rank("data")], device)
    camera = camera.to(device)
    target = torch.as_tensor(np.asarray(target), device=device)
    with _Tally() as tally:
        new, m = step(state, camera, target)
    return {**m, "step": new.step, "densify": new.densify_state, **tally.out}


def ring(rank, world, device, mesh_shape, cfg, shards, camera, background):
    """ring_bin_gather on this rank's row strip and shard, and
    ring_render_rows' images (with "normal" under cfg.render_normals)."""
    mesh = _mesh(mesh_shape, device)
    n_tile = mesh_shape[1]
    t_rank = mesh.get_local_rank("tile")
    shard = _to(shards[mesh.get_local_rank("data")], device)
    camera = camera.to(device)
    params = float_params(shard)
    offset = torch.zeros((shard.capacity, 2), device=device)
    rows = camera.height // n_tile
    crop = crop_camera_rows(camera, t_rank * rows, rows)
    with torch.no_grad(), _Tally() as tally:
        geom, feat, counts, stats, radii, valid = ring_bin_gather(
            params, shard.alive, offset, (crop, camera.tan_half_fov),
            camera.width, rows, cfg, mesh.get_group("data"))
        out = ring_render_rows(params, shard.alive, offset, camera, t_rank,
                               n_tile, cfg, torch.as_tensor(background,
                                                            device=device),
                               mesh.get_group("data"))
    return {"geom": geom, "feat": feat, "counts": counts, "stats": stats,
            "radii": radii, "valid": valid, "rgb": out["rgb"],
            "normal": out.get("normal"), **tally.out}


def densify(rank, world, device, mesh_shape, cfg, shards):
    """make_sharded_densify_step on this rank's shard: info and the
    gathered state."""
    mesh = _mesh(mesh_shape, device)
    state, info = make_sharded_densify_step(cfg, mesh)(
        _to(shards[mesh.get_local_rank("data")], device), True)
    return {"info": info, "state": gather_train_state(state, mesh)}


def compact_then_step(rank, world, device, mesh_shape, cfg, shards, headroom,
                      bucket, local_max, camera, target):
    """sharded_pool_target + make_sharded_compact, then one
    gaussian-sharded step (reference compositor) at the new capacity."""
    mesh = _mesh(mesh_shape, device)
    state = _to(shards[mesh.get_local_rank("data")], device)
    local = sharded_pool_target(state, mesh, headroom, bucket, local_max)
    state = make_sharded_compact(mesh)(state, local)
    gathered = gather_train_state(state, mesh)
    step = make_gaussian_sharded_train_step(cfg, mesh, impl="reference")
    state, m = step(state, camera.to(device),
                    torch.as_tensor(np.asarray(target), device=device))
    return {"local": local, "state": gathered, "loss": m["loss"],
            "step": state.step, "capacity": state.gaussians.capacity}


def rollout(rank, world, device, mesh_shape, background, urdfs, trajectory,
            cameras, cfg, impl="auto", as_uint8=False, **kw):
    """render_rollout(camera_mesh=, **kw) on this rank: every rank
    returns the whole (T, C, H, W, 3) frames, and the launches."""
    from robosimgs_tpu_torch.scenegen.rollout import (ArticulatedObject,
                                                      render_rollout)
    mesh = _mesh(mesh_shape, device)
    objects = [ArticulatedObject.from_urdf(u) for u in urdfs]
    background, cameras = _to(background, device), _to(cameras, device)
    with _Tally() as tally:
        frames = render_rollout(background, objects, trajectory, cameras,
                                cfg=cfg, impl=impl, camera_mesh=mesh,
                                as_uint8=as_uint8, **kw)
    return {"frames": frames, **tally.out}


def comm_totals(rank, world, device):
    """comm's totals on this rank so far: calls and bytes by op, bytes
    staged through the host."""
    return {"calls": dict(comm.COUNTS), "bytes": dict(comm.BYTES),
            "staged_bytes": comm.STAGED_BYTES[0]}


def cli_render_rollout(rank, world, device, argv):
    """cli.render_rollout.main(argv) on this rank (the CLI joins the
    ranks itself from torchrun's environment)."""
    from robosimgs_tpu_torch.cli import render_rollout as cli
    cli.main(list(argv))


def multihost_dp(rank, world, device, coordinator, dp_kw, backend=None):
    """initialize_multihost over tcp://coordinator (its backend, unless
    given), then dp_step(**dp_kw)."""
    initialize_multihost(coordinator, world, rank, device=device,
                         backend=backend)
    return dp_step(rank, world, device, **dp_kw)

