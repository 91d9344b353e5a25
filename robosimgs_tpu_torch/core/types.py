"""Gaussian-splat parameter set (a dataclass of tensors).

The canonical state of a 3DGS scene, as in robosimgs_tpu/core/types.py.
Parameters are stored in unconstrained form (log-scales,
logit-opacities, unnormalized quaternions); the activated values are
computed at projection time.

Capacity model: the tensors are allocated at a fixed capacity ``N`` and
an ``alive`` mask marks which slots are live, so a scene keeps its
shapes while slots are recycled. The PLY layout in train/io_ply.py
matches the standard 3DGS export.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

SH_C0 = 0.28209479177387814  # Y_00


@dataclasses.dataclass
class Gaussians:
    """A (capacity-N) set of 3D Gaussians.

    Attributes:
      means:       (N, 3) world-space centers.
      quats:       (N, 4) rotations, (w, x, y, z); normalized at use site.
      log_scales:  (N, 3) per-axis log standard deviations.
      logit_opacities: (N,) opacity in logit space; sigmoid at use site.
      sh_dc:       (N, 3) degree-0 SH coefficients (DC color term).
      sh_rest:     (N, K-1, 3) higher-degree SH coefficients, K = (deg+1)^2.
      alive:       (N,) bool mask of live slots.
    """

    means: torch.Tensor
    quats: torch.Tensor
    log_scales: torch.Tensor
    logit_opacities: torch.Tensor
    sh_dc: torch.Tensor
    sh_rest: torch.Tensor
    alive: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        k = 1 + self.sh_rest.shape[1]
        return int(round(k**0.5)) - 1

    @property
    def num_alive(self) -> torch.Tensor:
        return self.alive.sum()

    @property
    def device(self) -> torch.device:
        return self.means.device

    def to(self, device) -> "Gaussians":
        return Gaussians(**{f.name: getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})

    # -- activated views ---------------------------------------------------

    def scales(self) -> torch.Tensor:
        return torch.exp(self.log_scales)

    def opacities(self) -> torch.Tensor:
        return torch.sigmoid(self.logit_opacities)

    def normalized_quats(self) -> torch.Tensor:
        return self.quats / torch.linalg.norm(
            self.quats, dim=-1, keepdim=True).clamp_min(1e-12)

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_points(
        points: np.ndarray,
        colors: Optional[np.ndarray] = None,
        sh_degree: int = 3,
        capacity: Optional[int] = None,
        init_opacity: float = 0.1,
        init_scale: Optional[np.ndarray] = None,
        device="cuda",
    ) -> "Gaussians":
        """Initialize from a point cloud (e.g. SfM points or mesh samples).

        Scales default to the log of the mean distance to the 3 nearest
        neighbors (isotropic), the standard 3DGS initialization, computed
        on `device` by `knn_mean_dist`.
        """
        points = np.asarray(points, np.float32)
        n = points.shape[0]
        cap = capacity or n
        if cap < n:
            raise ValueError(f"capacity {cap} < n points {n}")
        k = (sh_degree + 1) ** 2

        means = np.zeros((cap, 3), np.float32)
        means[:n] = points
        quats = np.zeros((cap, 4), np.float32)
        quats[:, 0] = 1.0
        if init_scale is None:
            init_scale = knn_mean_dist(torch.from_numpy(points).to(device),
                                       k=3).cpu().numpy()
        init_scale = np.broadcast_to(
            np.asarray(init_scale, np.float32).reshape(-1, 1), (n, 3))
        log_scales = np.full((cap, 3), -5.0, np.float32)
        log_scales[:n] = np.log(np.clip(init_scale, 1e-7, None))
        logit_op = np.full((cap,), _logit(init_opacity), np.float32)
        sh_dc = np.zeros((cap, 3), np.float32)
        if colors is not None:
            sh_dc[:n] = rgb_to_sh(np.asarray(colors, np.float32))
        sh_rest = np.zeros((cap, k - 1, 3), np.float32)
        alive = np.zeros((cap,), bool)
        alive[:n] = True
        arrays = dict(means=means, quats=quats, log_scales=log_scales,
                      logit_opacities=logit_op, sh_dc=sh_dc, sh_rest=sh_rest,
                      alive=alive)
        return Gaussians(**{k: torch.from_numpy(v).to(device)
                            for k, v in arrays.items()})

    @staticmethod
    def random(
        generator: torch.Generator,
        n: int,
        sh_degree: int = 3,
        extent: float = 1.0,
        capacity: Optional[int] = None,
        device="cuda",
    ) -> "Gaussians":
        """Random scene for tests/benchmarks, drawn from a CPU
        `torch.Generator` (so a seed gives the same scene on any device).
        Its numbers differ from `jax.random`'s for the same seed."""
        def uniform(shape, lo, hi):
            return torch.rand(shape, generator=generator) * (hi - lo) + lo

        pts = uniform((n, 3), -extent, extent)
        cols = uniform((n, 3), 0.1, 0.9)
        g = Gaussians.from_points(
            pts.numpy(), cols.numpy(), sh_degree=sh_degree, capacity=capacity,
            init_scale=np.full((n,), 0.03 * extent, np.float32), device="cpu")
        quats = torch.randn((g.capacity, 4), generator=generator) * 0.1
        quats[:, 0] += 1.0
        lo = uniform((g.capacity,), -1.0, 2.0)
        return g.replace(quats=quats, logit_opacities=lo).to(device)

    def replace(self, **kw) -> "Gaussians":
        return dataclasses.replace(self, **kw)


def _logit(p: float) -> float:
    return float(np.log(p / (1.0 - p)))


def knn_mean_dist(points: torch.Tensor, k: int = 3) -> torch.Tensor:
    """(n, 3) points -> (n,) mean distance to the k nearest other points,
    clipped at 1e-7; 0.01 for a lone point. Exact (no matmul form of the
    distances), in row chunks of at most 2^26 distances, on the points'
    device. The JAX package's `_knn_mean_dist` in numpy."""
    n = points.shape[0]
    if n <= 1:
        return torch.full((n,), 0.01, device=points.device)
    kk = min(k, n - 1)
    chunk = max(1, (1 << 26) // n)
    out = []
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        d = torch.cdist(points[s:e], points,
                        compute_mode="donot_use_mm_for_euclid_dist")
        rows = torch.arange(e - s, device=points.device)
        d[rows, rows + s] = math.inf                           # not self
        near = torch.topk(d, kk, dim=1, largest=False).values
        out.append(torch.clamp_min(near, 1e-6).mean(1))
    return torch.clamp_min(torch.cat(out), 1e-7)


def rgb_to_sh(rgb):
    """Convert [0,1] RGB to the DC SH coefficient (3DGS convention)."""
    return (rgb - 0.5) / SH_C0


def sh_to_rgb(sh0):
    return sh0 * SH_C0 + 0.5
