"""Adaptive density control over a fixed-capacity pool.

A port of robosimgs_tpu/train/densify.py. The Gaussian tensors are a
fixed-capacity pool with an `alive` mask, and a densification round is
a handful of index ops:

  * screen-space gradient statistics are accumulated per step from the
    gradient of the `means2d_offset` probe (render/project.py);
  * growth candidates (avg grad > threshold) are matched to free slots
    by two stable argsorts (candidates by score desc, free slots by
    index) — graceful saturation when the pool fills (highest-scoring
    candidates win);
  * clone copies the Gaussian; split resamples source and child inside
    the parent ellipsoid and shrinks scales by 1.6x;
  * prune kills low-opacity / oversized Gaussians, freeing their slots
    in the same round.

Optimizer moments of every touched slot are zeroed by the caller via
`spawn_mask` (train/optim.py: reset_slots_in_opt_state). The split
offsets are normal draws from a `torch.Generator`; `_densify_with_draws`
takes them as arguments, so a test can hand it the JAX side's draws.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from robosimgs_tpu_torch.core.math3d import quat_to_rotmat
from robosimgs_tpu_torch.core.types import Gaussians
from robosimgs_tpu_torch.train.optim import OptState


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    grad_threshold: float = 2.0e-4       # on NDC-normalized screen grads
    percent_dense: float = 0.01          # split-vs-clone size boundary (x extent)
    split_scale_shrink: float = 1.6
    prune_opacity: float = 0.005
    prune_scale3d_max: float = 0.1       # x extent; 0 disables
    prune_scale3d_after: int = 3000      # size-pruning only after this step
    prune_radii2d_max: float = 0.0       # pixels; 0 disables
    reset_opacity_value: float = 0.01


@dataclasses.dataclass
class DensifyState:
    grad_accum: torch.Tensor   # (N,) sum of NDC grad norms
    count: torch.Tensor        # (N,) int32 frames the gaussian was visible in
    max_radii: torch.Tensor    # (N,) max screen radius seen (pixels)

    @staticmethod
    def zero(capacity: int, device="cuda") -> "DensifyState":
        return DensifyState(
            grad_accum=torch.zeros((capacity,), device=device),
            count=torch.zeros((capacity,), dtype=torch.int32, device=device),
            max_radii=torch.zeros((capacity,), device=device),
        )

    def map(self, fn) -> "DensifyState":
        return DensifyState(**{f.name: fn(getattr(self, f.name))
                               for f in dataclasses.fields(self)})


def update_stats(state: DensifyState, grad2d: torch.Tensor,
                 radii: torch.Tensor, valid: torch.Tensor, width: int,
                 height: int) -> DensifyState:
    """Accumulate screen-space gradient stats after one backward pass.

    grad2d: (N, 2) pixel-space gradient of the loss w.r.t. means2d (from
    the means2d_offset probe), converted to NDC-space gradients so
    grad_threshold keeps its standard 3DGS meaning: u_px = (ndc+1)*W/2,
    so dL/dndc = dL/du_px * W/2.
    """
    g = torch.stack([grad2d[:, 0] * (width / 2.0),
                     grad2d[:, 1] * (height / 2.0)], -1)
    norm = torch.linalg.norm(g, dim=-1)
    return DensifyState(
        grad_accum=state.grad_accum + torch.where(valid, norm, 0.0),
        count=state.count + valid.to(torch.int32),
        max_radii=torch.maximum(state.max_radii,
                                torch.where(valid, radii, 0.0)),
    )


def densify_and_prune(g: Gaussians, state: DensifyState,
                      generator: torch.Generator, cfg: DensifyConfig,
                      scene_extent: float, enable_scale_prune: bool = True,
                      return_info: bool = False):
    """One densification round. Returns (gaussians, reset state,
    spawn_mask); with return_info=True additionally a {"requested",
    "spawned", "pruned"} dict so pool-saturation truncation is counted,
    never silent.

    The two (N, 3) standard-normal split draws come from `generator`
    (a CPU generator: the same seed gives the same draws on any
    device). enable_scale_prune: size-based pruning gates on
    cfg.prune_scale3d_after in the trainer."""
    n = g.capacity
    e_child = torch.randn((n, 3), generator=generator).to(g.device)
    e_src = torch.randn((n, 3), generator=generator).to(g.device)
    return _densify_with_draws(g, state, e_child, e_src, cfg, scene_extent,
                               enable_scale_prune, return_info)


def _densify_with_draws(g: Gaussians, state: DensifyState,
                        e_child: torch.Tensor, e_src: torch.Tensor,
                        cfg: DensifyConfig, scene_extent: float,
                        enable_scale_prune: bool = True,
                        return_info: bool = False):
    """`densify_and_prune` after its two normal draws (e_child, e_src:
    (N, 3) standard normals for the child's and the split source's new
    positions)."""
    n = g.capacity
    dev = g.device
    avg = state.grad_accum / torch.clamp_min(state.count, 1).to(torch.float32)
    scales = g.scales()
    max_scale = torch.amax(scales, dim=-1)
    opac = g.opacities()

    prune = g.alive & (opac < cfg.prune_opacity)
    if enable_scale_prune and cfg.prune_scale3d_max > 0:
        prune |= g.alive & (max_scale > cfg.prune_scale3d_max * scene_extent)
    if enable_scale_prune and cfg.prune_radii2d_max > 0:
        prune |= g.alive & (state.max_radii > cfg.prune_radii2d_max)

    grow = g.alive & ~prune & (avg > cfg.grad_threshold) & (state.count > 0)
    big = max_scale > cfg.percent_dense * scene_extent
    split = grow & big

    # match spawn requests to free slots via two stable argsorts
    scores = torch.where(grow, avg, -math.inf)
    src = torch.argsort(-scores, stable=True)            # best requests first
    free = ~g.alive | prune
    dst = torch.argsort((~free).to(torch.int32), stable=True)  # free first
    n_req = grow.sum()
    n_free = free.sum()
    k = torch.arange(n, device=dev)
    do = (k < n_req) & (k < n_free)

    # split offsets inside the parent ellipsoid
    R = quat_to_rotmat(g.normalized_quats())             # (N, 3, 3)
    off_child = torch.einsum("nij,nj->ni", R, e_child * scales)
    off_src = torch.einsum("nij,nj->ni", R, e_src * scales)
    split_log_shrink = math.log(cfg.split_scale_shrink)

    # child values, gathered from the source and adjusted if split
    is_split_src = split[src]
    child_means = g.means[src] + torch.where(is_split_src[:, None],
                                             off_child[src], 0.0)
    child_log_scales = g.log_scales[src] - torch.where(
        is_split_src[:, None], split_log_shrink, 0.0)

    def scatter(x, upd):
        # dst is a permutation: every slot is written at most once
        out = x.clone()
        keep = do.reshape((-1,) + (1,) * (x.dim() - 1))
        out[dst] = torch.where(keep, upd, x[dst])
        return out

    alive = g.alive & ~prune
    means = scatter(g.means, child_means)
    log_scales = scatter(g.log_scales, child_log_scales)
    quats = scatter(g.quats, g.quats[src])
    logit_op = scatter(g.logit_opacities, g.logit_opacities[src])
    sh_dc = scatter(g.sh_dc, g.sh_dc[src])
    sh_rest = scatter(g.sh_rest, g.sh_rest[src])
    alive = scatter(alive, torch.ones_like(alive))

    # in-place modification of split sources that actually spawned
    src_modified = torch.zeros((n,), dtype=torch.bool, device=dev)
    src_modified[src] = do & is_split_src
    means = torch.where(src_modified[:, None], means + off_src, means)
    log_scales = torch.where(src_modified[:, None],
                             log_scales - split_log_shrink, log_scales)

    new = g.replace(means=means, quats=quats, log_scales=log_scales,
                    logit_opacities=logit_op, sh_dc=sh_dc, sh_rest=sh_rest,
                    alive=alive)
    spawned = torch.zeros((n,), dtype=torch.bool, device=dev)
    spawned[dst] = do
    spawn_mask = spawned | src_modified | prune
    zero = DensifyState.zero(n, device=dev)
    if return_info:
        info = {"requested": n_req, "spawned": torch.minimum(n_req, n_free),
                "pruned": prune.sum()}
        return new, zero, spawn_mask, info
    return new, zero, spawn_mask


def compact_and_resize(g: Gaussians, opt_state: OptState,
                       dstate: DensifyState, new_capacity: int):
    """Alive-prefix compaction + pool resize.

    One stable permutation moves live Gaussians to a prefix (relative
    order, and so training semantics, preserved) and slices/pads every
    capacity-leading tensor (parameters, Adam moments, densify
    statistics) to `new_capacity`, so per-step optimizer and projection
    work scales with the alive count. Adam counts are not per slot and
    are kept. Returns (gaussians, opt_state, densify_state).
    """
    n = g.capacity
    perm = torch.argsort((~g.alive).to(torch.int32), stable=True)

    def fix(x):
        if x.dim() == 0 or x.shape[0] != n:
            return x
        y = x[perm]
        if new_capacity <= n:
            return y[:new_capacity]
        pad = torch.zeros((new_capacity - n,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        return torch.cat([y, pad], dim=0)

    g2 = g.replace(**{f.name: fix(getattr(g, f.name))
                      for f in dataclasses.fields(g)})
    if new_capacity > n:
        # dead-slot padding: identity quat and tiny log-scale, as
        # Gaussians.from_points pads; alive pads False
        quats = g2.quats.clone()
        quats[n:, 0] = 1.0
        log_scales = g2.log_scales.clone()
        log_scales[n:] = -5.0
        g2 = g2.replace(quats=quats, log_scales=log_scales)
    opt2 = {k: s.map_slots(fix) for k, s in opt_state.items()}
    return g2, opt2, dstate.map(fix)


def reset_opacities(g: Gaussians, value: float = 0.01) -> Gaussians:
    """Periodic opacity clamp-down (3DGS opacity reset)."""
    cap = math.log(value / (1.0 - value))
    return g.replace(logit_opacities=torch.clamp_max(g.logit_opacities, cap))
