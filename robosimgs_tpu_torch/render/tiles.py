"""Shared tile geometry helpers (used by the reference path and binning).

Both rasterization paths use the same definition of "Gaussian touches
tile": the inclusive tile-index bbox of the splat's radius square. Pixels
have centers at integer coordinates; pixel j lives in tile j // tile_size.
Binning enumerates a bbox's tiles row-major (`_bbox_slots`) and drops the
tiles the splat's ellipse cannot reach (`_cull_keep`, exact).
"""

from __future__ import annotations

import torch


def num_tiles(width: int, height: int, tile_size: int):
    return -(-width // tile_size), -(-height // tile_size)


def tile_bbox(means2d: torch.Tensor, radii: torch.Tensor, tiles_x: int,
              tiles_y: int, tile_size: int):
    """Inclusive tile-index bbox (tx0, ty0, tx1, ty1), each (N,) int64.

    Invalid/zero-radius Gaussians produce an empty bbox (tx1 < tx0).
    """
    u, v = means2d[:, 0], means2d[:, 1]

    def edge(x, hi):
        return torch.clamp(torch.floor(x / tile_size), 0, hi - 1).long()

    tx0 = edge(u - radii, tiles_x)
    ty0 = edge(v - radii, tiles_y)
    tx1 = edge(u + radii, tiles_x)
    ty1 = edge(v + radii, tiles_y)
    tx1 = torch.where(radii <= 0.0, tx0 - 1, tx1)
    return tx0, ty0, tx1, ty1


def _bbox_slots(tx0, ty0, tx1, ty1, n_slots: int, tiles_x: int):
    """Row-major enumeration of up to n_slots tiles of each inclusive
    tile bbox: (tid, row, col, in_bbox) (n, n_slots) and cover (n,)."""
    bw = (tx1 - tx0 + 1).clamp_min(0)
    cover = bw * (ty1 - ty0 + 1).clamp_min(0)
    e = torch.arange(n_slots, device=tx0.device)[None, :]
    bw_safe = bw.clamp_min(1)[:, None]
    row = torch.div(e, bw_safe, rounding_mode="floor")
    col = e - row * bw_safe
    tid = (ty0[:, None] + row) * tiles_x + (tx0[:, None] + col)
    return tid, row, col, e < cover[:, None], cover


def cull_qcut(op: torch.Tensor, alpha_min: float) -> torch.Tensor:
    """The exact cull's cut on q: log(op / alpha_min), op clamped to
    1e-12 (elementwise, any shape)."""
    return torch.log(torch.clamp_min(op, 1e-12) / alpha_min)


def _cull_keep(m2d, cop, tx0, ty0, col, row, tile_size: int,
               alpha_min: float) -> torch.Tensor:
    """Exact ellipse-tile intersection keep-mask for (N, M) candidate
    tiles: keep iff min over the tile's pixel-center rect of the
    quadratic form q = .5*ca*u^2 + cb*u*v + .5*cc*v^2 is <=
    log(op / alpha_min) — a dropped tile has alpha < alpha_min at EVERY
    pixel, so the compositor keep-mask zeroes it anyway; culling is
    lossless. The rect min of the PSD quadratic is 0 if the mean is
    inside, else the min over the four clamped edge restrictions.

    m2d (N, 2) screen means; cop (N, 4) [conic_a, conic_b, conic_c,
    opacity]; tx0/ty0 (N,) bbox tile origins; col/row (N, M) candidate
    offsets within the bbox.
    """
    return _cull_keep_q(m2d, cop[:, 0:3], cull_qcut(cop[:, 3:4], alpha_min),
                        tx0, ty0, col, row, tile_size)


def _cull_keep_q(m2d, conic, qcut, tx0, ty0, col, row,
                 tile_size: int) -> torch.Tensor:
    """`_cull_keep` with the cut given: conic (N, 3), qcut (N, 1)."""
    ts_f = float(tile_size)
    ca, cb, cc = conic[:, 0:1], conic[:, 1:2], conic[:, 2:3]
    u0 = (tx0[:, None] + col).float() * ts_f - m2d[:, 0:1]
    v0 = (ty0[:, None] + row).float() * ts_f - m2d[:, 1:2]
    u1 = u0 + (ts_f - 1.0)
    v1 = v0 + (ts_f - 1.0)
    ca_s = torch.clamp_min(ca, 1e-12)
    cc_s = torch.clamp_min(cc, 1e-12)

    def edge_u(uf):  # u fixed, v free in [v0, v1]
        vs = torch.minimum(torch.maximum(-cb * uf / cc_s, v0), v1)
        return (0.5 * ca) * uf * uf + cb * uf * vs + (0.5 * cc) * vs * vs

    def edge_v(vf):  # v fixed, u free in [u0, u1]
        us = torch.minimum(torch.maximum(-cb * vf / ca_s, u0), u1)
        return (0.5 * ca) * us * us + cb * us * vf + (0.5 * cc) * vf * vf

    qmin = torch.minimum(torch.minimum(edge_u(u0), edge_u(u1)),
                         torch.minimum(edge_v(v0), edge_v(v1)))
    inside = (u0 <= 0.0) & (0.0 <= u1) & (v0 <= 0.0) & (0.0 <= v1)
    qmin = torch.where(inside, torch.zeros_like(qmin), qmin)
    # cull only with a definitely-PSD conic (conservative otherwise)
    psd = (ca > 0.0) & (cc > 0.0)
    return ~psd | (qmin <= qcut)
