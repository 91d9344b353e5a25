"""F train steps per call: the port of the JAX package's fused dispatch
(`make_fused_train_steps`, a lax.scan of the one-step body).

The frames of a run are stacked on the device (`FrameStack`): step s
trains on frame s % n, as the unfused loop does, so a step needs no
input from the host. `FusedSteps(train_step)` then runs F steps of that
same step function:

  * on CPU tensors, a Python loop of F calls;
  * on CUDA tensors, one step captured once as a CUDA graph and
    replayed F times. The captured step reads the state from the
    graph's own input buffers and writes the new state back into them,
    so one replay is one whole step: the forward and backward kernels,
    `torch.autograd.grad`, the densify statistics, Adam. The step
    counter, and through it the frame index and the SH band mask, is a
    device tensor among those buffers; each replay writes its metrics
    into row j of a (F,) buffer per metric.

Each call copies the state into the buffers first (densify, an opacity
reset, a pool resize or a restored checkpoint replace the tensors
between calls) and hands back clones, never the buffers a later replay
overwrites. A new capacity (pool resize), frame stack or F captures
anew and frees the old graph. Before a capture two steps run eagerly on
a side stream, on the buffers (a copy of the state), which loads the
kernels and makes every cached device constant; the real state does not
advance. A capture that fails raises: nothing falls back to the eager
loop.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from robosimgs_tpu_torch.core.camera import Camera


def select(x: torch.Tensor, idx):
    """x[idx] for an int idx, or for a (1,) int64 device tensor (an
    index_select: reading it as a Python int would wait for the device,
    which a captured graph may not)."""
    if isinstance(idx, torch.Tensor):
        return x.index_select(0, idx.reshape(1)).squeeze(0)
    return x[idx]


@dataclasses.dataclass
class FrameStack:
    """Every frame's camera, target (n, H, W, 3) and depth (n, H, W) or
    None, stacked on one device; the cameras as one Camera with a
    leading (n,) axis. All frames share one resolution."""

    cameras: Camera
    targets: torch.Tensor
    depths: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.targets.shape[0]

    def camera(self, idx) -> Camera:
        c = self.cameras
        return dataclasses.replace(
            c, fx=select(c.fx, idx), fy=select(c.fy, idx),
            cx=select(c.cx, idx), cy=select(c.cy, idx),
            c2w=select(c.c2w, idx))

    def target(self, idx) -> torch.Tensor:
        return select(self.targets, idx)

    def depth(self, idx) -> Optional[torch.Tensor]:
        return None if self.depths is None else select(self.depths, idx)


def stack_cameras(cameras: Sequence[Camera]) -> Camera:
    """One Camera with a leading axis from cameras of one resolution."""
    sizes = {(c.width, c.height) for c in cameras}
    if len(sizes) != 1:
        raise ValueError(f"stacked cameras need one resolution, got {sizes}")
    return Camera(**{k: torch.stack([getattr(c, k) for c in cameras])
                     for k in ("fx", "fy", "cx", "cy", "c2w")},
                  width=cameras[0].width, height=cameras[0].height)


def stack_frames(cameras: Sequence[Camera], targets: Sequence[np.ndarray],
                 depths: Optional[Sequence[np.ndarray]],
                 device) -> FrameStack:
    def up(arrays):
        return torch.from_numpy(np.ascontiguousarray(
            np.stack(arrays), np.float32)).to(device)

    return FrameStack(
        cameras=stack_cameras([c.to(device) for c in cameras]),
        targets=up(targets), depths=None if depths is None else up(depths))


def map_state(fn: Callable, state):
    """A TrainState with fn applied to every tensor of its Gaussians,
    optimizer groups, densify statistics, exposure and bilateral grids;
    step and generator kept. Groups are visited in sorted order."""
    def fields(x):
        return dataclasses.replace(x, **{
            f.name: None if getattr(x, f.name) is None
            else fn(getattr(x, f.name)) for f in dataclasses.fields(x)})

    return dataclasses.replace(
        state, gaussians=fields(state.gaussians),
        opt_state={k: fields(state.opt_state[k])
                   for k in sorted(state.opt_state)},
        densify_state=fields(state.densify_state),
        exposure=None if state.exposure is None else fn(state.exposure),
        bilagrid=None if state.bilagrid is None else fn(state.bilagrid))


def state_tensors(state) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    map_state(lambda t: out.append(t) or t, state)
    return out


class FusedSteps:
    """fused(state, frames, n_steps) -> (state after n_steps, metrics
    stacked (n_steps,) per key), step for step the unfused loop of
    `train_step`. capture_seconds lists the one-off time of each graph
    capture (warm-up included)."""

    def __init__(self, train_step: Callable):
        self.train_step = train_step
        self.capture_seconds: List[float] = []
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._frames: Optional[FrameStack] = None   # held: the graph reads it
        self._key = None
        # the graph's buffers: the state it steps, its metrics (one row a
        # replay) and the row index
        self._static = self._metrics = self._row = None

    def __call__(self, state, frames: FrameStack, n_steps: int):
        if state.gaussians.device.type == "cuda":
            return self._replay(state, frames, n_steps)
        ms = []
        for _ in range(n_steps):
            idx = state.step % frames.n
            state, m = self.train_step(state, frames.camera(idx),
                                       frames.target(idx), idx,
                                       frames.depth(idx))
            ms.append(m)
        return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    def _one_step(self, frames: FrameStack):
        """One step on the graph's buffers, written back into them."""
        st = self._static
        idx = torch.remainder(st.step, frames.n).reshape(1)
        new, metrics = self.train_step(st, frames.camera(idx),
                                       frames.target(idx), idx,
                                       frames.depth(idx))
        with torch.no_grad():
            for a, b in zip(state_tensors(st), state_tensors(new)):
                if a is not b:
                    a.copy_(b)
            st.step.copy_(new.step)
        return metrics

    def _capture(self, state, frames: FrameStack, n_steps: int) -> None:
        dev = state.gaussians.device
        if self._graph is not None:      # a new capacity: free the old one
            self._graph.reset()
            self._graph = self._static = self._metrics = None
        t0 = time.perf_counter()
        self._static = map_state(torch.clone, state)
        self._static.step = torch.tensor(state.step, dtype=torch.int64,
                                         device=dev)
        self._row = torch.zeros((1,), dtype=torch.int64, device=dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                metrics = self._one_step(frames)
        torch.cuda.current_stream(dev).wait_stream(side)
        self._metrics = {k: torch.zeros((n_steps,), dtype=v.dtype, device=dev)
                         for k, v in metrics.items()}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            metrics = self._one_step(frames)
            for k, v in metrics.items():
                self._metrics[k].index_copy_(0, self._row, v.reshape(1))
            self._row.add_(1)
        torch.cuda.synchronize(dev)
        self._graph = graph
        self.capture_seconds.append(time.perf_counter() - t0)

    def _replay(self, state, frames: FrameStack, n_steps: int):
        key = (state.gaussians.capacity, n_steps)
        if key != self._key or frames is not self._frames:
            self._capture(state, frames, n_steps)
            self._key, self._frames = key, frames
        st = self._static
        with torch.no_grad():
            for a, b in zip(state_tensors(st), state_tensors(state)):
                a.copy_(b)
            st.step.fill_(state.step)
            self._row.zero_()
        for _ in range(n_steps):
            self._graph.replay()
        out = map_state(torch.clone, st)
        out = dataclasses.replace(out, step=state.step + n_steps,
                                  generator=state.generator)
        return out, {k: v.clone() for k, v in self._metrics.items()}
