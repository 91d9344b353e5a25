"""Per-frame bilateral-grid color correction (splatfacto's
`use_bilateral_grid`, from "Bilateral Guided Radiance Field Processing").

A port of robosimgs_tpu/train/bilagrid.py. Each frame owns a (gh, gw,
gl, 12) grid of 3x4 color affines; a pixel at (y, x) with rendered
luminance g is corrected by the affine trilinearly interpolated at grid
coordinate (y/H, x/W, g).

The spatial (y, x) interpolation weights are fixed per pixel, so all
luminance levels are interpolated at once by one plain f32 matmul
(P, gh*gw) @ (gh*gw, gl*12) (TF32 stays off: the package sets it);
the luminance axis is then a hat-function weighted sum. The dense weight
matrix is O(P * gh*gw), so the pixel axis is cut into row blocks of
about 2^16 pixels, walked by a Python loop (the JAX package's lax.map),
the last block zero-padded as there.

Where a max or min ties (a black pixel, a gray value on a grid level),
the gradient is JAX's (train/losses.py's maximum, minimum, absolute):
uncovered pixels of a black background tie on every step.
"""

from __future__ import annotations

import torch

from robosimgs_tpu_torch.train.losses import absolute, maximum, minimum

_GRAY = (0.299, 0.587, 0.114)
_IDENTITY = (1.0, 0.0, 0.0, 0.0,
             0.0, 1.0, 0.0, 0.0,
             0.0, 0.0, 1.0, 0.0)

# pixels per block of the blocked evaluation: 2^16 keeps the weight
# matrix ~16 MB at (8, 8, 4)
_CHUNK_PIXELS = 1 << 16


def identity_bilagrid(n_frames: int, shape: tuple = (8, 8, 4),
                      device="cuda") -> torch.Tensor:
    """(n_frames, gh, gw, gl, 12) grids of identity color affines."""
    gh, gw, gl = shape
    e = torch.tensor(_IDENTITY, dtype=torch.float32, device=device)
    return e.expand(n_frames, gh, gw, gl, 12).clone()


def _spatial_weights(py: torch.Tensor, h: int, w: int, gh: int,
                     gw: int) -> torch.Tensor:
    """(len(py)*W, gh*gw) bilinear interpolation weights, pixel-major,
    for the image rows listed in `py` (row indices of the full h-row
    frame). Align-corners: pixel centers map to [0, g-1] linearly. Rows
    sum to 1, with at most 4 nonzeros; no gradient flows through them."""
    dev = py.device
    px = torch.arange(w, dtype=torch.float32, device=dev)[None, :]   # (1, W)
    fy = py.to(torch.float32)[:, None] * ((gh - 1) / max(h - 1, 1))
    fx = px * ((gw - 1) / max(w - 1, 1))
    ly = torch.arange(gh, dtype=torch.float32, device=dev)
    lx = torch.arange(gw, dtype=torch.float32, device=dev)
    wy = torch.clamp_min(1.0 - torch.abs(fy[..., None] - ly), 0.0)  # (R, 1, gh)
    wx = torch.clamp_min(1.0 - torch.abs(fx[..., None] - lx), 0.0)  # (1, W, gw)
    w2 = wy[:, :, :, None] * wx[:, :, None, :]             # (R, W, gh, gw)
    return w2.reshape(-1, gh * gw)


def _apply_block(grid: torch.Tensor, rgb_rows: torch.Tensor, y0: int,
                 h: int) -> torch.Tensor:
    """Correct one contiguous block of image rows. rgb_rows: (R, W, 3);
    y0: its first row in the full h-row frame."""
    gh, gw, gl, _ = grid.shape
    r, w, _ = rgb_rows.shape
    dev = rgb_rows.device
    flat = rgb_rows.reshape(-1, 3)                          # (P, 3)
    py = y0 + torch.arange(r, device=dev)
    sw = _spatial_weights(py, h, w, gh, gw)                 # (P, gh*gw)
    s = sw @ grid.reshape(gh * gw, gl * 12)                 # (P, gl*12)
    s = s.reshape(-1, gl, 12)
    # luminance axis: hat-function weights from the rendered gray value
    # the luminance weights made on the device: no host copy, so a CUDA
    # graph can capture them
    gray_w = torch.stack([flat.new_full((), c) for c in _GRAY])
    gray = minimum(maximum(flat @ gray_w, 0.0), 1.0)
    pos = gray * (gl - 1)                                   # (P,)
    lv = torch.arange(gl, dtype=torch.float32, device=dev)
    wl = maximum(1.0 - absolute(pos[:, None] - lv), 0.0)        # (P, gl)
    a = torch.einsum("pl,plc->pc", wl, s).reshape(-1, 3, 4)  # (P, 3, 4)
    out = torch.einsum("pij,pj->pi", a[:, :, :3], flat) + a[:, :, 3]
    return maximum(out, 0.0).reshape(r, w, 3)


def apply_bilagrid(grid: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """Correct a rendered image with one frame's bilateral grid.

    grid: (gh, gw, gl, 12) — 3x4 affines, row-major ([r_row, g_row,
    b_row] each [wr, wg, wb, bias]). rgb: (H, W, 3). Returns (H, W, 3),
    clipped at 0 like the exposure path (trainer.py). Frames of more
    than _CHUNK_PIXELS pixels go in blocks of _CHUNK_PIXELS // W rows;
    gradients flow to the grid and to rgb through every block."""
    h, w, _ = rgb.shape
    rows_c = max(1, _CHUNK_PIXELS // w)
    if h <= rows_c:                                         # one block
        return _apply_block(grid, rgb, 0, h)
    n = -(-h // rows_c)
    pad = n * rows_c - h
    rgbp = torch.cat([rgb, rgb.new_zeros((pad, w, 3))]) if pad else rgb
    blocks = rgbp.reshape(n, rows_c, w, 3)
    out = torch.stack([_apply_block(grid, blocks[i], i * rows_c, h)
                       for i in range(n)])
    return out.reshape(n * rows_c, w, 3)[:h]


def tv_loss(grid: torch.Tensor) -> torch.Tensor:
    """Mean squared finite difference along the three grid axes (all
    frames): keeps unobserved grid regions near their neighbors.
    grid: (..., gh, gw, gl, 12)."""
    dy = grid[..., 1:, :, :, :] - grid[..., :-1, :, :, :]
    dx = grid[..., :, 1:, :, :] - grid[..., :, :-1, :, :]
    dl = grid[..., :, :, 1:, :] - grid[..., :, :, :-1, :]
    return (torch.mean(dy * dy) + torch.mean(dx * dx)
            + torch.mean(dl * dl))
