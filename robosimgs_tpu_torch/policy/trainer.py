"""Diffusion-policy training on rendered rollout data.

A port of robosimgs_tpu/policy/trainer.py: DDPM epsilon-prediction
(sample a diffusion timestep, noise the ground-truth action sequence,
regress the noise conditioned on the (images, proprioception)
observation window), with AdamW under optax's warmup-cosine schedule
and an EMA of the weights, on one device (`cuda` unless the caller asks
for the CPU).

Windows are picked on the host with numpy's default_rng(seed), as the
JAX trainer picks them, so both draw the same batch indices for a seed;
each batch is gathered on the host and copied to the device. The
diffusion timesteps, the noise and the augmentation's shifts and gains
come from a torch.Generator (seed + 1) on the device, whose streams
differ from JAX's; `policy_loss` and `augment` take the draws as
arguments so that tests can feed both packages the same ones.

The optimizer is torch.optim.AdamW with optax.adamw's semantics: the
moments and their bias correction with the count incremented first,
eps 1e-8 outside the square root, decoupled weight decay on every
parameter, and the learning rate read at the count BEFORE its
increment, so the first update has lr 0 (the warmup's start).
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from robosimgs_tpu_torch.policy.diffusion import (DiffusionPolicy,
                                                  DiffusionPolicyConfig,
                                                  NoiseSchedule,
                                                  sample_actions)


@dataclasses.dataclass(frozen=True)
class PolicyTrainConfig:
    policy: DiffusionPolicyConfig = DiffusionPolicyConfig()
    lr: float = 1e-4
    weight_decay: float = 1e-6
    warmup_steps: int = 500
    total_steps: int = 50_000
    batch_size: int = 64
    ema_decay: float = 0.995
    # train-time image augmentation: per-sample random shift (wrap-roll,
    # +-shift_px) and brightness/contrast jitter, the same for every
    # frame of an observation window. Eval stays clean.
    augment: bool = False
    aug_shift_px: int = 4
    aug_color: float = 0.2


@dataclasses.dataclass
class RolloutDataset:
    """In-memory (images, states, actions) episodes with window sampling.

    images:  (N, H, W, 3) float32   — frames of all episodes concatenated
    states:  (N, state_dim)
    actions: (N, action_dim)
    episode_ends: indices where episodes end (windows never cross them).
    """

    images: np.ndarray
    states: np.ndarray
    actions: np.ndarray
    episode_ends: List[int]

    def normalization(self) -> Dict[str, np.ndarray]:
        return {
            "action_min": self.actions.min(0),
            "action_max": self.actions.max(0),
            "state_mean": self.states.mean(0),
            "state_std": self.states.std(0) + 1e-6,
        }

    def windows(self, obs_horizon: int, horizon: int) -> np.ndarray:
        """Valid window start indices."""
        starts = []
        begin = 0
        for end in self.episode_ends:
            last = end - (obs_horizon + horizon) + 1
            if last > begin:
                starts.extend(range(begin, last))
            begin = end
        return np.asarray(starts, np.int64)

    def batch(self, rng: np.random.Generator, idx: np.ndarray,
              obs_horizon: int, horizon: int, norm: Dict) -> Tuple:
        obs_i = idx[:, None] + np.arange(obs_horizon)[None, :]
        act_i = idx[:, None] + obs_horizon - 1 + np.arange(horizon)[None, :]
        images = self.images[obs_i]
        states = (self.states[obs_i] - norm["state_mean"]) / norm["state_std"]
        span = np.maximum(norm["action_max"] - norm["action_min"], 1e-6)
        actions = (self.actions[act_i] - norm["action_min"]) / span * 2 - 1
        return images, states.astype(np.float32), actions.astype(np.float32)


def lr_at(cfg: PolicyTrainConfig, count: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup_steps,
    max(total_steps, warmup_steps + 1)) at `count`: linear from 0 over
    the warmup, then a cosine to 0 over the remaining steps."""
    warm = cfg.warmup_steps
    if count < warm:
        return cfg.lr * count / warm
    decay = max(cfg.total_steps, warm + 1) - warm
    c = min(count - warm, decay)
    return cfg.lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))


def augment(images: torch.Tensor, shifts: torch.Tensor, bright: torch.Tensor,
            contrast: torch.Tensor) -> torch.Tensor:
    """images (B, O, H, W, 3) rolled over (H, W) by shifts (B, 2) (as
    jnp.roll: out[i] = in[(i - s) mod n]), then contrast and brightness
    (B, 1, 1, 1, 1) about each frame's per-channel mean, clipped to
    [0, 1]; one shift and one gain pair per window."""
    _, _, H, W, _ = images.shape
    dev = images.device
    rows = (torch.arange(H, device=dev)[None, :] - shifts[:, :1]) % H
    cols = (torch.arange(W, device=dev)[None, :] - shifts[:, 1:]) % W
    imgs = torch.take_along_dim(images, rows[:, None, :, None, None], dim=2)
    imgs = torch.take_along_dim(imgs, cols[:, None, None, :, None], dim=3)
    mean = imgs.mean(dim=(2, 3), keepdim=True)
    return torch.clamp((imgs - mean) * contrast + mean * bright, 0.0, 1.0)


def policy_loss(model: DiffusionPolicy, images: torch.Tensor,
                states: torch.Tensor, actions: torch.Tensor, t: torch.Tensor,
                noise: torch.Tensor, schedule: NoiseSchedule) -> torch.Tensor:
    """The DDPM loss at given draws: mean squared error of the predicted
    noise on actions noised to timesteps t."""
    noisy = schedule.add_noise(actions, noise, t)
    return torch.mean((model(images, states, noisy, t) - noise) ** 2)


def predict_actions(model: DiffusionPolicy, schedule: NoiseSchedule,
                    norm: Dict[str, np.ndarray], images: np.ndarray,
                    states: np.ndarray, generator: torch.Generator,
                    n_steps: Optional[int] = 16) -> np.ndarray:
    """Sample an action sequence for host observations (B, O, H, W, 3),
    (B, O, state_dim) on the schedule's device, from noise drawn from
    `generator`, and denormalize it to action units (B, horizon, dof)."""
    dev = schedule.betas.device
    pc = model.cfg
    s = ((states - norm["state_mean"]) / norm["state_std"]).astype(np.float32)
    x_T = torch.randn((images.shape[0], pc.horizon, pc.action_dim),
                      generator=generator, device=dev)
    acts = sample_actions(
        model, schedule, torch.as_tensor(images, dtype=torch.float32,
                                         device=dev),
        torch.from_numpy(s).to(dev), x_T, n_steps=n_steps)
    span = np.maximum(norm["action_max"] - norm["action_min"], 1e-6)
    return (acts.cpu().numpy() + 1) / 2 * span + norm["action_min"]


class PolicyTrainer:
    def __init__(self, cfg: PolicyTrainConfig, dataset: RolloutDataset,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.dataset = dataset
        self.device = torch.device(device)
        self.norm = dataset.normalization()
        self.model = DiffusionPolicy(
            cfg.policy, torch.Generator().manual_seed(seed)).to(self.device)
        self.ema_model = copy.deepcopy(self.model).requires_grad_(False)
        self.schedule = NoiseSchedule.make(cfg.policy, self.device)
        self.optimizer = torch.optim.AdamW(
            self.model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay)
        self.count = 0          # updates applied (optax's schedule count)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        pc = cfg.policy
        self.starts = dataset.windows(pc.obs_horizon, pc.horizon)
        self.history: List[Dict] = []

    def sample_batch(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The next batch on the host: windows drawn by the numpy rng."""
        pc = self.cfg.policy
        idx = self.rng.choice(self.starts, size=self.cfg.batch_size)
        return self.dataset.batch(self.rng, idx, pc.obs_horizon, pc.horizon,
                                  self.norm)

    def to_device(self, batch) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.from_numpy(np.asarray(x)).to(self.device,
                                                        torch.float32)
                     for x in batch)

    def apply_update(self) -> None:
        """One AdamW update from the parameters' .grad at the scheduled
        lr (read before the count increments), then the EMA."""
        for group in self.optimizer.param_groups:
            group["lr"] = lr_at(self.cfg, self.count)
        self.optimizer.step()
        self.count += 1
        d = self.cfg.ema_decay
        with torch.no_grad():
            ema = list(self.ema_model.parameters())
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, list(self.model.parameters()),
                                alpha=1 - d)

    def train_step(self, images: torch.Tensor, states: torch.Tensor,
                   actions: torch.Tensor) -> torch.Tensor:
        """One step on a device batch; returns the loss (0-d, on the
        device, not synchronized)."""
        cfg, g, dev = self.cfg, self.generator, self.device
        b = actions.shape[0]
        if cfg.augment:
            sp, col = cfg.aug_shift_px, cfg.aug_color
            shifts = torch.randint(-sp, sp + 1, (b, 2), generator=g,
                                   device=dev)
            bright, contrast = (
                1.0 + col * (2.0 * torch.rand((b, 1, 1, 1, 1), generator=g,
                                              device=dev) - 1.0)
                for _ in range(2))
            images = augment(images, shifts, bright, contrast)
        t = torch.randint(0, cfg.policy.diffusion_steps, (b,), generator=g,
                          device=dev)
        noise = torch.randn(actions.shape, generator=g, device=dev)
        loss = policy_loss(self.model, images, states, actions, t, noise,
                           self.schedule)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.apply_update()
        return loss.detach()

    def run(self, steps: int, log_every: int = 100, progress: bool = True):
        t0 = time.time()
        for i in range(steps):
            loss = self.train_step(*self.to_device(self.sample_batch()))
            if i % log_every == 0:
                row = {"step": i, "loss": float(loss),
                       "elapsed": time.time() - t0}
                self.history.append(row)
                if progress:
                    print(f"[{i:6d}] loss={row['loss']:.4f} "
                          f"({row['elapsed']:.1f}s)")

    def predict(self, images: np.ndarray, states: np.ndarray,
                n_steps: Optional[int] = 16) -> np.ndarray:
        """Sample an action sequence with the EMA weights and denormalize
        it to action units."""
        return predict_actions(self.ema_model, self.schedule, self.norm,
                               images, states, self.generator, n_steps)


def save_policy(path: str, trainer: PolicyTrainer) -> None:
    """torch.save of the EMA weights, the normalization (tensors) and the
    config (a plain dict): loadable with weights_only=True."""
    torch.save({"state_dict": trainer.ema_model.state_dict(),
                "norm": {k: torch.from_numpy(np.asarray(v))
                         for k, v in trainer.norm.items()},
                "config": dataclasses.asdict(trainer.cfg)}, path)


def load_policy(path: str, device="cuda"):
    """(DiffusionPolicy on `device`, normalization as numpy, the
    PolicyTrainConfig) from a save_policy file."""
    blob = torch.load(path, map_location=device, weights_only=True)
    raw = dict(blob["config"])
    pol = raw.pop("policy")
    pc = DiffusionPolicyConfig(**{**pol,
                                  "image_size": tuple(pol["image_size"])})
    model = DiffusionPolicy(pc).to(device)
    model.load_state_dict(blob["state_dict"])
    norm = {k: v.cpu().numpy() for k, v in blob["norm"].items()}
    return model, norm, PolicyTrainConfig(policy=pc, **raw)
