"""Gathered-tile compositor in plain torch, plus tile <-> image layout.

`composite_gathered` runs on the same (T, 8, K) gathered blocks as the
compositing kernel with the reference math (cumulative log-space
transmittance, per-tile count mask), so either can be held against it
elementwise, and torch autograd of it against the backward kernel. Runs
anywhere.
"""

from __future__ import annotations

import torch

from robosimgs_tpu_torch.render.config import RenderConfig

# tiles per pass: bounds the (tiles, P, K) temporaries
_TILE_CHUNK = 64


def tile_pixel_coords(t_idx: torch.Tensor, tiles_x: int, ts: int):
    """(n,) within-image tile indices -> px, py (n, P) f32 pixel centers."""
    p = torch.arange(ts * ts, device=t_idx.device)
    px = ((t_idx % tiles_x)[:, None] * ts + p[None, :] % ts).float()
    py = ((t_idx // tiles_x)[:, None] * ts + p[None, :] // ts).float()
    return px, py


def tile_alpha_parts(g: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                     in_count: torch.Tensor, cfg: RenderConfig,
                     dlim: torch.Tensor | None = None):
    """`tile_alpha` and what the backward needs beside it: (alpha, keep,
    raw = opacity * e^-q before the clamp, dx, dy), each (n, P, k)."""
    dx = px[:, :, None] - g[:, None, 0]
    dy = py[:, :, None] - g[:, None, 1]
    q = 0.5 * (g[:, None, 2] * dx * dx + g[:, None, 4] * dy * dy) \
        + g[:, None, 3] * dx * dy
    raw = g[:, None, 5] * torch.exp(-q)
    alpha = torch.clamp_max(raw, cfg.alpha_clamp)
    keep = in_count[:, None, :] & (alpha >= cfg.alpha_min) & (q >= 0.0)
    if dlim is not None:
        keep = keep & (g[:, None, 6] <= dlim[:, :, None])
    return torch.where(keep, alpha, torch.zeros_like(alpha)), keep, raw, dx, dy


def tile_alpha(g: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
               in_count: torch.Tensor, cfg: RenderConfig,
               dlim: torch.Tensor | None = None) -> torch.Tensor:
    """Masked alpha (n, P, k) of k gathered splats g (n, 8, k) at pixel
    centers px/py (n, P): zero unless the slot is in the tile's count
    (in_count (n, k)), alpha >= alpha_min, q >= 0 and, with dlim (n, P),
    the splat's depth (geom row 6) is within the pixel's limit."""
    return tile_alpha_parts(g, px, py, in_count, cfg, dlim)[0]


def composite_gathered(
    geom: torch.Tensor,    # (T, 8, K)
    feat: torch.Tensor,    # (T, 8, K)
    counts: torch.Tensor,  # (T,)
    tiles_x: int,
    cfg: RenderConfig,
    dlim: torch.Tensor | None = None,   # (T, P) per-pixel depth limits
    t_idx: torch.Tensor | None = None,  # (T,) within-image tile index
) -> torch.Tensor:
    """Returns (T, 8, P) per-tile feature images, P = tile_size**2.

    t_idx overrides the per-row tile index used for pixel coordinates —
    multi-camera batches concatenate the tile axis, so row i of image j
    uses t_idx[i] = i % tiles_per_image."""
    ts = cfg.tile_size
    T, _, K = geom.shape
    dev = geom.device
    if t_idx is None:
        t_idx = torch.arange(T, device=dev)
    outs = []
    for s in range(0, T, _TILE_CHUNK):
        e = min(s + _TILE_CHUNK, T)
        g, f = geom[s:e], feat[s:e]
        px, py = tile_pixel_coords(t_idx[s:e], tiles_x, ts)
        in_count = torch.arange(K, device=dev)[None, :] < counts[s:e, None]
        alpha = tile_alpha(g, px, py, in_count, cfg,
                           None if dlim is None else dlim[s:e])
        lg = torch.log1p(-alpha)
        excl = torch.cumsum(lg, dim=2) - lg
        Tk = torch.exp(excl)
        w = alpha * Tk * (Tk * (1.0 - alpha) >= cfg.transmittance_min)
        outs.append(torch.einsum("nck,npk->ncp", f, w))
    if not outs:
        return geom.new_zeros((0, 8, ts * ts))
    return torch.cat(outs)


def untile(out_tiles: torch.Tensor, tiles_x: int, tiles_y: int,
           width: int, height: int, tile_size: int) -> torch.Tensor:
    """(T, 8, P) per-tile features -> (H, W, 8) image (cropped)."""
    ts = tile_size
    img = out_tiles.reshape(tiles_y, tiles_x, 8, ts, ts)
    img = img.permute(0, 3, 1, 4, 2).reshape(tiles_y * ts, tiles_x * ts, 8)
    return img[:height, :width]


def tile_image(img: torch.Tensor, tiles_x: int, tiles_y: int,
               tile_size: int, pad_value: float = 0.0) -> torch.Tensor:
    """(H, W) scalar image -> (T, P) per-tile pixel rows (padded)."""
    ts = tile_size
    H, W = img.shape
    padded = torch.full((tiles_y * ts, tiles_x * ts), pad_value,
                        dtype=img.dtype, device=img.device)
    padded[:H, :W] = img
    t = padded.reshape(tiles_y, ts, tiles_x, ts).permute(0, 2, 1, 3)
    return t.reshape(tiles_y * tiles_x, ts * ts)

