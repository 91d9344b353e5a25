"""Device meshes and axis conventions on torch.distributed.

A port of robosimgs_tpu/parallel/mesh.py. Axes, as in the JAX package:
  data — cameras / rollout batch (DP), or the shards of the Gaussian set;
         the gradient all-reduce rides this axis.
  tile — image row strips of one frame (the SP/CP analog).

Every rank is one process and runs the per-device function itself (the
JAX package's shard_map body). Ranks are laid out row-major, as
`np.asarray(devices).reshape(n_data, n_tile)` lays out the JAX devices:
tile rank = rank % n_tile, data rank = rank // n_tile. So the data group
of a tile rank t holds the ranks t, t + n_tile, ..., in data order, and
an all_gather over it concatenates shards in global order.

Multi-host: 'data' outermost (slower links), 'tile' inside, as in the JAX
package's pod recipe.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES = ("data", "tile")


def make_mesh(n_data: Optional[int] = None, n_tile: int = 1,
              ranks: Optional[Sequence[int]] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "tile") DeviceMesh over `ranks` (default: the first
    n_data * n_tile ranks of the world), row-major. Every rank of the
    world calls it (the groups are made collectively); a rank outside
    `ranks` holds a mesh it takes no part in (get_coordinate() is None).
    device_type "cuda" unless the caller asks for "cpu"."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_tile
    if ranks is None:
        ranks = range(n_data * n_tile)
    ranks = list(ranks)
    if len(ranks) != n_data * n_tile or max(ranks) >= world:
        raise ValueError(f"mesh ({n_data}, {n_tile}) over ranks {ranks} "
                         f"of a world of {world}")
    return DeviceMesh(device_type,
                      torch.tensor(ranks, dtype=torch.int64).reshape(
                          n_data, n_tile),
                      mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The mesh's size along `axis` (DeviceMesh.size takes the dim's
    index). A rank's index along it, the JAX package's lax.axis_index, is
    mesh.get_local_rank(axis); its line's process group
    mesh.get_group(axis)."""
    return mesh.size(AXES.index(axis))


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: str = "cuda",
                         backend: Optional[str] = None) -> None:
    """Multi-process bring-up over `tcp://coordinator` (host:port): NCCL
    for ranks on CUDA devices, gloo when the caller asks for the CPU or
    for gloo (NCCL takes one rank a card). A CUDA rank takes card
    LOCAL_RANK (default process_id) modulo the cards of its host. Does
    nothing for one process or when a process group exists already."""
    if num_processes in (None, 1) or dist.is_initialized():
        return
    if backend is None:
        backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    if torch.device(device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
