"""Training losses: L1 + SSIM (the 3DGS photometric loss) and PSNR.

A port of robosimgs_tpu/train/losses.py. The loss is
(1-lambda)*L1 + lambda*(1-SSIM), lambda=0.2, the splatfacto loss. SSIM
uses the standard 11-tap Gaussian window (sigma 1.5) as two f32
band-matrix products, the JAX package's form (TF32 stays off: the
package pins it at import).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


# Where a max, a min or |x| ties, JAX's gradient differs from torch's
# clamp and abs: jnp.maximum and jnp.minimum pass half of it to each side
# at equality, jnp.abs has slope 1 at 0. These three are the port's
# forms of them wherever the tie is common: on a black background every
# uncovered pixel renders exactly 0 and matches its target exactly.


def maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    """max(x, c) with jnp.maximum's gradient: half at x == c."""
    return torch.maximum(x, x.new_full((), c))


def minimum(x: torch.Tensor, c: float) -> torch.Tensor:
    """min(x, c) with jnp.minimum's gradient: half at x == c."""
    return torch.minimum(x, x.new_full((), c))


def absolute(x: torch.Tensor) -> torch.Tensor:
    """|x| with jnp.abs's gradient: slope 1 at 0 (torch.abs: 0)."""
    return torch.where(x >= 0.0, x, -x)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(absolute(pred - target))


def psnr(pred: torch.Tensor, target: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(max_val**2 / torch.clamp_min(mse, 1e-12))


@functools.lru_cache(maxsize=8)
def _gauss_window_np(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size) - size // 2
    w = np.exp(-(x**2) / (2 * sigma**2))
    return (w / w.sum()).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _band_matrix_np(length: int, size: int, sigma: float) -> np.ndarray:
    """(length, length) banded blur matrix == separable 1D conv with
    SAME zero padding (out-of-range taps contribute 0)."""
    w = _gauss_window_np(size, sigma)
    m = np.zeros((length, length), np.float32)
    half = size // 2
    for k in range(size):
        off = k - half
        d = np.full(length - abs(off), w[k], np.float32)
        m += np.diag(d, off)
    return m


@functools.lru_cache(maxsize=16)
def _band_matrix(length: int, size: int, sigma: float,
                 device: torch.device) -> torch.Tensor:
    """_band_matrix_np on `device`, copied there once (a copy from
    pageable memory has no place inside a captured CUDA graph)."""
    return torch.from_numpy(_band_matrix_np(length, size, sigma)).to(device)


def _blur(img: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """Separable blur of (H, W, C), SAME padding, as two band-matrix
    products in f32."""
    H, W, C = img.shape
    bh = _band_matrix(H, size, sigma, img.device)
    bw = _band_matrix(W, size, sigma, img.device)
    x = (bh @ img.reshape(H, W * C)).reshape(H, W, C)
    return torch.einsum("hwc,vw->hvc", x, bw)


def ssim(pred: torch.Tensor, target: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, c1: float = 0.01**2,
         c2: float = 0.03**2) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) image pair in [0, 1]."""
    mu_p = _blur(pred, window_size, sigma)
    mu_t = _blur(target, window_size, sigma)
    mu_pp = mu_p * mu_p
    mu_tt = mu_t * mu_t
    mu_pt = mu_p * mu_t
    sig_p = _blur(pred * pred, window_size, sigma) - mu_pp
    sig_t = _blur(target * target, window_size, sigma) - mu_tt
    sig_pt = _blur(pred * target, window_size, sigma) - mu_pt
    num = (2 * mu_pt + c1) * (2 * sig_pt + c2)
    den = (mu_pp + mu_tt + c1) * (sig_p + sig_t + c2)
    return torch.mean(num / den)


def photometric_loss(pred: torch.Tensor, target: torch.Tensor,
                     ssim_lambda: float = 0.2) -> torch.Tensor:
    return (1.0 - ssim_lambda) * l1_loss(pred, target) \
        + ssim_lambda * (1.0 - ssim(pred, target))


def normals_from_depth(depth: torch.Tensor, fx, fy, cx, cy):
    """Camera-space surface normals from a depth map by central
    differences of the unprojected point map (the geometric target of
    the 2DGS-style normal-consistency regularizer).

    depth: (H, W) camera-space z. Returns (normals (H, W, 3) unit,
    oriented toward the camera; valid (H, W) bool — border pixels, where
    the central difference wraps, are invalid). Pixel centers sit at
    integer coords with u = fx*x/z + cx - 0.5, so unprojection uses
    (u + 0.5 - cx) / fx.
    """
    h, w = depth.shape
    u = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :] + 0.5
    v = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None] + 0.5
    p = torch.stack([depth * (u - cx) / fx, depth * (v - cy) / fy, depth], -1)
    du = torch.roll(p, -1, dims=1) - torch.roll(p, 1, dims=1)
    dv = torch.roll(p, -1, dims=0) - torch.roll(p, 1, dims=0)
    n = torch.linalg.cross(dv, du)
    # rsqrt of a clamped square, not n / max(norm, eps): the norm's own
    # gradient at 0 is NaN and would poison gated-out pixels
    sq = torch.sum(n * n, -1, keepdim=True)
    n = n * torch.rsqrt(torch.clamp_min(sq, 1e-20))
    flip = torch.where(torch.sum(n * p, -1) > 0.0, -1.0, 1.0)
    n = n * flip[..., None]
    valid = torch.zeros((h, w), dtype=torch.bool, device=depth.device)
    valid[1:-1, 1:-1].fill_(True)    # no host copy: a CUDA graph may hold it
    return n, valid
