"""Per-parameter-group Adam for Gaussian splats.

A port of robosimgs_tpu/train/optim.py, with optax's semantics written
out as a small functional Adam over a state dict of tensors (densify
and pool compaction permute, reset and resize its moment rows, and the
opacity reset zeroes one group's count, which torch.optim.Adam's state
does not lend itself to):

  * each group keeps optax.scale_by_adam's (count, mu, nu); an update
    increments the count first and bias-corrects with the new count;
  * means get an exponentially decaying lr scaled by the scene extent,
    read through optax.scale_by_schedule's own count BEFORE it is
    incremented, so the first update uses lr(0);
  * every other field has its own constant lr; eps = 1e-15;
  * with exposure_lr / bilagrid_lr the state also holds an "exposure"
    (per-frame color affines) and a "bilagrid" (per-frame bilateral
    grids) group, each its own Adam (optax's multi_transform labels).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from robosimgs_tpu_torch.core.types import Gaussians


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    means_lr_init: float = 1.6e-4      # x scene_extent
    means_lr_final: float = 1.6e-6     # x scene_extent
    means_lr_max_steps: int = 30_000
    sh_dc_lr: float = 2.5e-3
    sh_rest_lr: float = 2.5e-3 / 20.0
    opacity_lr: float = 0.05
    scale_lr: float = 5.0e-3
    quat_lr: float = 1.0e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-15


FLOAT_FIELDS = ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
                "sh_rest")


def float_params(g: Gaussians) -> dict:
    """The trainable (float) fields of a Gaussians as a dict — the
    parameter structure the optimizer operates on (`alive` is a liveness
    mask, not a parameter)."""
    return {k: getattr(g, k) for k in FLOAT_FIELDS}


def means_schedule(cfg: OptimConfig, scene_extent: float) -> Callable:
    """count (0-d int tensor) -> the means lr, log-linear from
    init to final over means_lr_max_steps, in f32 as optax computes it."""
    init = cfg.means_lr_init * scene_extent
    final = cfg.means_lr_final * scene_extent

    log_init, log_final = math.log(init), math.log(final)

    def sched(count: torch.Tensor) -> torch.Tensor:
        t = torch.clamp(count.to(torch.float32) / cfg.means_lr_max_steps,
                        0.0, 1.0)
        return torch.exp((1 - t) * log_init + t * log_final)

    return sched


@dataclasses.dataclass
class AdamGroup:
    """One parameter group's optimizer state: optax.scale_by_adam's
    (count, mu, nu) and, for a scheduled lr, scale_by_schedule's count."""

    mu: torch.Tensor
    nu: torch.Tensor
    count: torch.Tensor                          # 0-d int32
    sched_count: Optional[torch.Tensor] = None   # 0-d int32

    def map_slots(self, fn) -> "AdamGroup":
        """fn applied to the per-slot arrays (mu, nu); counts kept."""
        return dataclasses.replace(self, mu=fn(self.mu), nu=fn(self.nu))


OptState = Dict[str, AdamGroup]


class GroupAdam:
    """Adam with one learning rate per parameter group (the JAX
    package's optax.multi_transform of per-field optax.adam)."""

    def __init__(self, cfg: OptimConfig = OptimConfig(),
                 scene_extent: float = 1.0,
                 exposure_lr: Optional[float] = None,
                 bilagrid_lr: Optional[float] = None):
        self.cfg = cfg
        self.lr = {
            "means": means_schedule(cfg, scene_extent),
            "quats": cfg.quat_lr,
            "log_scales": cfg.scale_lr,
            "logit_opacities": cfg.opacity_lr,
            "sh_dc": cfg.sh_dc_lr,
            "sh_rest": cfg.sh_rest_lr,
        }
        if exposure_lr is not None:
            self.lr["exposure"] = exposure_lr
        if bilagrid_lr is not None:
            self.lr["bilagrid"] = bilagrid_lr

    def init(self, params: dict) -> OptState:
        state = {}
        for k, p in params.items():
            zero = torch.zeros((), dtype=torch.int32, device=p.device)
            state[k] = AdamGroup(
                mu=torch.zeros_like(p), nu=torch.zeros_like(p), count=zero,
                sched_count=zero.clone() if callable(self.lr[k]) else None)
        return state

    def step(self, params: dict, grads: dict,
             state: OptState) -> tuple[dict, OptState]:
        """One update of every group: (new params, new state)."""
        b1, b2, eps = self.cfg.b1, self.cfg.b2, self.cfg.eps
        new_params, new_state = {}, {}
        for k, p in params.items():
            s, g = state[k], grads[k]
            mu = (1 - b1) * g + b1 * s.mu
            nu = (1 - b2) * (g * g) + b2 * s.nu
            count = s.count + 1
            c = count.to(torch.float32)
            mu_hat = mu / (1 - torch.pow(b1, c))
            nu_hat = nu / (1 - torch.pow(b2, c))
            u = mu_hat / (torch.sqrt(nu_hat) + eps)
            lr = self.lr[k]
            sched_count = s.sched_count
            if callable(lr):
                u = -lr(sched_count) * u
                sched_count = sched_count + 1
            else:
                u = u * -lr
            new_params[k] = p + u
            new_state[k] = AdamGroup(mu=mu, nu=nu, count=count,
                                     sched_count=sched_count)
        return new_params, new_state


def make_optimizer(cfg: OptimConfig = OptimConfig(),
                   scene_extent: float = 1.0,
                   exposure_lr: Optional[float] = None,
                   bilagrid_lr: Optional[float] = None) -> GroupAdam:
    """exposure_lr / bilagrid_lr: when set, the params additionally
    carry an "exposure" / "bilagrid" entry, each its own Adam group."""
    return GroupAdam(cfg, scene_extent, exposure_lr, bilagrid_lr)


def reset_slots_in_opt_state(state: OptState,
                             spawn_mask: torch.Tensor) -> OptState:
    """Zero the Adam moments of re-spawned capacity slots.

    spawn_mask: (N,) bool — slots whose parameters were overwritten by
    densification; their stale moments must not leak into the new
    Gaussian's updates. Counts are not per slot and are kept. As in the
    JAX package the rule is the leading dimension, so a per-frame group
    whose frame count equals the capacity is reset too."""
    def reset(x):
        if x.dim() >= 1 and x.shape[0] == spawn_mask.shape[0]:
            mask = spawn_mask.reshape((-1,) + (1,) * (x.dim() - 1))
            return torch.where(mask, torch.zeros_like(x), x)
        return x

    return {k: s.map_slots(reset) for k, s in state.items()}

