"""Collectives of the port: the one place torch.distributed moves data.

The JAX package's lax collectives inside shard_map, as functions of a
process group (a DeviceMesh's `get_group(axis)`):

  all_gather(x, group, dim)   lax.all_gather(tiled=True), differentiable:
                              its backward is a SUM reduce-scatter,
                              exactly all_gather's transpose in JAX (the
                              sharded steps' pmean over 'tile' and
                              1/(n_shard n_tile) scale rely on it; torch's
                              own differentiable all_gather goes through
                              all_to_all off NCCL)
  psum / pmean / pmax         lax.psum / pmean / pmax (an OR of bools is
                              a pmax of 0/1, packed with the radii)
  rotate(tensors, group)      ppermute to (i + 1) % n, from (i - 1) % n,
                              one batch_isend_irecv; the identity when
                              n == 1 (NCCL does not send to itself)

Every call is counted in COUNTS (calls) and BYTES (bytes sent) by op.

gloo and CUDA tensors: on torch 2.11 gloo takes CUDA tensors for
all_reduce, all_gather_into_tensor and reduce_scatter_tensor, and fails
batch_isend_irecv on them (writev: Bad address; measured on an H100,
GLOO_CUDA_NATIVE). For an op outside that set on a gloo group this
module copies a CUDA tensor through pinned host memory and back, counts
the bytes in STAGED_BYTES and says so on stderr once. Compute stays on
the card; NCCL groups never stage.
"""

from __future__ import annotations

import collections
import sys
from typing import List, Sequence

import torch
import torch.distributed as dist

# torch 2.13 renames the tensor-to-tensor collectives; 2.11 has only the
# old names (same semantics)
_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor

GLOO_CUDA_NATIVE = frozenset({"all_reduce", "all_gather", "reduce_scatter"})

COUNTS: collections.Counter = collections.Counter()
BYTES: collections.Counter = collections.Counter()
STAGED_BYTES = [0]
_said = [False]


def _count(op: str, tensors: Sequence[torch.Tensor]) -> None:
    COUNTS[op] += 1
    BYTES[op] += sum(t.numel() * t.element_size() for t in tensors)


def _stages(op: str, group, x: torch.Tensor) -> bool:
    if not x.is_cuda or op in GLOO_CUDA_NATIVE \
            or dist.get_backend(group) != "gloo":
        return False
    if not _said[0]:
        _said[0] = True
        print(f"parallel.comm: gloo group with CUDA tensors: {op} is "
              "staged through pinned host memory (gloo does not take it on "
              "the card)", file=sys.stderr)
    return True


def _host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    STAGED_BYTES[0] += x.numel() * x.element_size()
    return h


def _back(h: torch.Tensor, device) -> torch.Tensor:
    STAGED_BYTES[0] += h.numel() * h.element_size()
    return h.to(device)


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    """all_gather along dim 0 of a contiguous tensor."""
    n = dist.get_world_size(group)
    _count("all_gather", [x])
    stage = _stages("all_gather", group, x)
    src = _host(x) if stage else x
    out = src.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather_single(out, src, group=group)
    return _back(out, x.device) if stage else out


def _reduce_scatter0(x: torch.Tensor, group) -> torch.Tensor:
    """SUM reduce-scatter along dim 0 of a contiguous tensor."""
    n = dist.get_world_size(group)
    _count("reduce_scatter", [x])
    stage = _stages("reduce_scatter", group, x)
    src = _host(x) if stage else x
    out = src.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    _reduce_scatter_single(out, src, op=dist.ReduceOp.SUM, group=group)
    return _back(out, x.device) if stage else out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        y = _gather0(x.movedim(dim, 0).contiguous(), group)
        return y.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        y = _reduce_scatter0(g.movedim(ctx.dim, 0).contiguous(), ctx.group)
        return y.movedim(0, ctx.dim), None, None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's x along `dim`, in group rank order;
    differentiable (backward: SUM reduce-scatter of the cotangent)."""
    return _AllGather.apply(x, group, dim)


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    y = x.detach().clone().contiguous()
    _count("all_reduce", [y])
    stage = _stages("all_reduce", group, y)
    buf = _host(y) if stage else y
    dist.all_reduce(buf, op=op, group=group)
    return _back(buf, y.device) if stage else buf


def psum(x: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce(x, group, dist.ReduceOp.SUM)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """psum / n, as lax.pmean."""
    return psum(x, group) / dist.get_world_size(group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce(x, group, dist.ReduceOp.MAX)



def rotate(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Each rank's tensors to rank (i + 1) % n of the group, from rank
    (i - 1) % n: lax.ppermute over a ring, in one batch_isend_irecv."""
    n = dist.get_world_size(group)
    _count("rotate", tensors)
    if n == 1:
        return list(tensors)
    i = dist.get_rank(group)
    dst = dist.get_global_rank(group, (i + 1) % n)
    src = dist.get_global_rank(group, (i - 1) % n)
    stage = _stages("rotate", group, tensors[0])
    sends = [(_host(t) if stage else t.contiguous()) for t in tensors]
    recvs = [torch.empty_like(s) for s in sends]
    ops = []
    for s, r in zip(sends, recvs):
        ops.append(dist.P2POp(dist.isend, s, dst, group))
        ops.append(dist.P2POp(dist.irecv, r, src, group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if stage:
        return [_back(r, t.device) for r, t in zip(recvs, tensors)]
    return recvs
