"""Diffusion Policy for visuomotor control (pipeline stage 5).

A port of robosimgs_tpu/policy/diffusion.py as torch modules: a
vision+proprioception encoder (a strided CNN over the stacked camera
frames, global average pooling or a spatial-softmax keypoint head)
conditions a residual FiLM-MLP that predicts the noise over an
action-sequence horizon; training is DDPM epsilon-prediction; inference
runs the deterministic DDIM reverse process over a strided timestep grid.

The flax modules' semantics are kept where torch's defaults differ:
SAME padding of the stride-2 convs pads (0, 1) on even sizes and (1, 1)
on odd ones; GELU is the tanh approximation; LayerNorm's eps is 1e-6;
weights start from lecun_normal (a normal truncated at 2 sigma, scaled
to variance 1/fan_in), biases from 0. The frames are stacked into
channels by a row-major reshape of the NHWC tensor, as the reference
does (for two frames: frame 0 fills the top half of the rows, frame 1
the bottom, each new row packing two source rows); only then is the
tensor permuted to NCHW. Parameters carry over from the JAX package
with core/convert.policy_params_from_numpy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# std of a unit normal truncated to [-2, 2]: lecun_normal divides by it
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class DiffusionPolicyConfig:
    action_dim: int = 7
    horizon: int = 16                 # predicted action steps
    obs_horizon: int = 2              # stacked observation frames
    image_size: Tuple[int, int] = (96, 96)
    state_dim: int = 7                # proprioception
    embed_dim: int = 256
    hidden_dim: int = 512
    n_blocks: int = 4
    diffusion_steps: int = 100
    beta_start: float = 1e-4
    beta_end: float = 0.02
    # spatial-softmax visual head: per-channel soft-argmax keypoints
    # instead of global average pooling
    spatial_softmax: bool = False


def cosine_time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding (t in [0, T))."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=generator)


def _linear(n_in: int, n_out: int, generator: torch.Generator) -> nn.Linear:
    layer = nn.Linear(n_in, n_out)
    with torch.no_grad():
        _lecun_normal_(layer.weight, n_in, generator)
        layer.bias.zero_()
    return layer


def _same_pad(size: int, stride: int = 2, k: int = 3) -> Tuple[int, int]:
    """flax's SAME padding (lo, hi) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class ObsEncoder(nn.Module):
    """Strided CNN over stacked camera frames + proprioception MLP."""

    def __init__(self, cfg: DiffusionPolicyConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        chans = [3 * cfg.obs_horizon, 32, 64, 128, 256]
        self.convs = nn.ModuleList()
        for c_in, c_out in zip(chans[:-1], chans[1:]):
            conv = nn.Conv2d(c_in, c_out, 3, stride=2)
            with torch.no_grad():
                _lecun_normal_(conv.weight, 9 * c_in, generator)
                conv.bias.zero_()
            self.convs.append(conv)
        feat = chans[-1] * (2 if cfg.spatial_softmax else 1)
        if cfg.spatial_softmax:
            self.ss_log_temp = nn.Parameter(torch.zeros((1,)))
        self.state = _linear(cfg.obs_horizon * cfg.state_dim, cfg.embed_dim,
                             generator)
        self.head = _linear(feat + cfg.embed_dim, cfg.embed_dim, generator)

    def forward(self, images: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
        # images: (B, obs_horizon, H, W, 3); state: (B, obs_horizon, state_dim)
        b = images.shape[0]
        x = images.reshape(b, images.shape[2], images.shape[3], -1)
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            (h_lo, h_hi), (w_lo, w_hi) = (_same_pad(x.shape[2]),
                                          _same_pad(x.shape[3]))
            x = _gelu(conv(F.pad(x, (w_lo, w_hi, h_lo, h_hi))))
        if self.cfg.spatial_softmax:
            _, ch, hh, wh = x.shape
            flat = (x.permute(0, 2, 3, 1).reshape(b, hh * wh, ch)
                    * torch.exp(self.ss_log_temp))
            att = torch.softmax(flat, dim=1)
            ys, xs = torch.meshgrid(
                torch.linspace(-1, 1, hh, device=x.device),
                torch.linspace(-1, 1, wh, device=x.device), indexing="ij")
            pos = torch.stack([xs.reshape(-1), ys.reshape(-1)], 1)  # (HW, 2)
            x = torch.einsum("bpc,pk->bck", att, pos).reshape(b, 2 * ch)
        else:
            x = x.mean(dim=(2, 3))                     # global average pool
        s = self.state(state.reshape(b, -1))
        return self.head(torch.cat([x, _gelu(s)], -1))


class FiLMBlock(nn.Module):
    def __init__(self, hidden_dim: int, cond_dim: int,
                 generator: torch.Generator):
        super().__init__()
        self.h = _linear(hidden_dim, hidden_dim, generator)
        self.scale = _linear(cond_dim, hidden_dim, generator)
        self.shift = _linear(cond_dim, hidden_dim, generator)
        self.norm = nn.LayerNorm(hidden_dim, eps=1e-6)
        self.out = _linear(hidden_dim, hidden_dim, generator)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = _gelu(self.norm(self.h(x)) * (1 + self.scale(cond))
                  + self.shift(cond))
        return x + self.out(h)


class Denoiser(nn.Module):
    """Residual FiLM-MLP epsilon-predictor over the action horizon."""

    def __init__(self, cfg: DiffusionPolicyConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        e, h = cfg.embed_dim, cfg.hidden_dim
        self.t_proj = _linear(e, e, generator)
        self.cond = _linear(2 * e, e, generator)
        self.inp = _linear(cfg.horizon * cfg.action_dim, h, generator)
        self.blocks = nn.ModuleList(FiLMBlock(h, e, generator)
                                    for _ in range(cfg.n_blocks))
        self.out = _linear(h, cfg.horizon * cfg.action_dim, generator)

    def forward(self, noisy_actions: torch.Tensor, t: torch.Tensor,
                obs_embed: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b = noisy_actions.shape[0]
        t_emb = self.t_proj(cosine_time_embedding(t, cfg.embed_dim))
        cond = _gelu(self.cond(torch.cat([obs_embed, _gelu(t_emb)], -1)))
        x = self.inp(noisy_actions.reshape(b, -1))
        for block in self.blocks:
            x = block(x, cond)
        return self.out(x).reshape(b, cfg.horizon, cfg.action_dim)


class DiffusionPolicy(nn.Module):
    """The encoder and the denoiser. Weights are drawn from `generator`
    (default: a CPU generator seeded 0) on the CPU; move the module with
    .to(device)."""

    def __init__(self, cfg: DiffusionPolicyConfig,
                 generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        g = generator or torch.Generator().manual_seed(0)
        self.encoder = ObsEncoder(cfg, g)
        self.denoiser = Denoiser(cfg, g)

    def forward(self, images, state, noisy_actions, t):
        return self.denoiser(noisy_actions, t, self.encoder(images, state))

    def encode(self, images, state):
        return self.encoder(images, state)

    def denoise(self, noisy_actions, t, obs_embed):
        return self.denoiser(noisy_actions, t, obs_embed)


@dataclasses.dataclass
class NoiseSchedule:
    """DDPM linear-beta schedule with precomputed alphas."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor

    @staticmethod
    def make(cfg: DiffusionPolicyConfig, device="cuda") -> "NoiseSchedule":
        betas = torch.linspace(cfg.beta_start, cfg.beta_end,
                               cfg.diffusion_steps, device=device)
        return NoiseSchedule(betas=betas,
                             alphas_cumprod=torch.cumprod(1.0 - betas, 0))

    def add_noise(self, actions, noise, t):
        ac = self.alphas_cumprod[t][..., None, None]
        return torch.sqrt(ac) * actions + torch.sqrt(1.0 - ac) * noise


def timestep_grid(diffusion_steps: int, n_steps: int) -> List[int]:
    """The reverse process's timesteps, T-1 down to 0 in n_steps: the
    reference's f32 `jnp.linspace(T - 1, 0, n).round()`, i.e.
    start·(1 − i·(1/div)) in f32 (XLA folds the division by the constant
    div into a product with its f32 reciprocal, and that rounding decides
    the ties), the last entry exactly 0, rounded half to even."""
    if n_steps == 1:
        return [diffusion_steps - 1]
    div = n_steps - 1
    step = (torch.arange(div, dtype=torch.float32)
            * torch.tensor(1.0 / div, dtype=torch.float32))
    grid = torch.round(float(diffusion_steps - 1) * (1 - step))
    return [int(v) for v in grid] + [0]


@torch.no_grad()
def sample_actions(model: DiffusionPolicy, schedule: NoiseSchedule,
                   images: torch.Tensor, state: torch.Tensor,
                   x_T: torch.Tensor, n_steps: int = None) -> torch.Tensor:
    """Reverse diffusion from the initial noise x_T (B, horizon,
    action_dim) to actions (B, horizon, action_dim): the deterministic
    DDIM update over timestep_grid; n_steps < T strides the grid."""
    T = model.cfg.diffusion_steps
    ts = timestep_grid(T, n_steps or T)
    obs_embed = model.encode(images, state)
    b = images.shape[0]
    ac = schedule.alphas_cumprod
    x = x_T
    for i, t in enumerate(ts):
        eps = model.denoise(x, torch.full((b,), t, device=x.device), obs_embed)
        ac_t = ac[t]
        x0 = (x - torch.sqrt(1 - ac_t) * eps) / torch.sqrt(ac_t)
        # clip to the normalized action range (min-max scaled to [-1, 1])
        x0 = torch.clamp(x0, -1.0, 1.0)
        if i + 1 < len(ts):
            ac_next = ac[ts[i + 1]]
            x = torch.sqrt(ac_next) * x0 + torch.sqrt(1 - ac_next) * eps
        else:   # t_next = -1: alphas_cumprod 1, the update returns x0
            x = x0
    return x
