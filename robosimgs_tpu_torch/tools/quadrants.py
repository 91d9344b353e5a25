"""The forward kernel on a tile against the same tile cut into quadrants.

Each tile of even size ts becomes the four tiles of size ts / 2 that
cover its quadrants: the grid has twice the tiles a row, and half-size
tile (2 X + qx, 2 Y + qy) of an image takes tile (X, Y)'s splats, count
and (quadrant of) depth limits. Each pixel sees the same splats in the
same order at the same coordinates, so a kernel that keeps every
pixel's order of operations gives it the same weights in both runs. Only
the stop differs: a quadrant stops at the first batch boundary where its
own pixels saturate, the whole tile where all four have, so a tile's
nblk is the largest of its quadrants', and a pixel gets no weight after
its quadrant stops (its T is below t_min there already).

    full = composite_fwd(geom, feat, counts, dlim, **kw)
    half = composite_fwd(*quadrant_blocks(geom, feat, counts, dlim, **kw))
    quadrant_diffs(full, half, **kw)

`quadrant_diffs` holds the two: out on every pixel, log_t_final on the
quadrants whose nblk equals the tile's, log_t_groups on the batches both
processed. `forward_diffs` holds two forwards on the same tiles (the
kernel's walks of every slot and of the slots its footprint test keeps).
chip_smoke.py and tests/test_torch_cuda.py require every difference to
be 0.0 (the sign of a zero is none).
"""

from __future__ import annotations

import dataclasses

import torch

from robosimgs_tpu_torch.render.kernels import BK, LT_GROUP


def _quadrant_index(T: int, tiles_x: int, n_tiles_per_image: int,
                    device) -> torch.Tensor:
    """(T, 4): the half-size tile that takes quadrant qy * 2 + qx of tile
    t (tiles concatenated by image, n_tiles_per_image each)."""
    n = n_tiles_per_image or T
    t = torch.arange(T, device=device)
    img, tl = t // n, t % n
    X, Y = tl % tiles_x, tl // tiles_x
    q = torch.arange(4, device=device)
    qx, qy = q % 2, q // 2
    return (img[:, None] * 4 * n + (2 * Y[:, None] + qy) * (2 * tiles_x)
            + 2 * X[:, None] + qx)


def _quadrants(x: torch.Tensor, ts: int) -> torch.Tensor:
    """(T, C, ts*ts) -> (T, 4, C, h*h), h = ts / 2, quadrant qy * 2 + qx
    of each tile's pixels, row-major."""
    T, C, _ = x.shape
    h = ts // 2
    x = x.reshape(T, C, 2, h, 2, h).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(T, 4, C, h * h)


def quadrant_blocks(geom, feat, counts, dlim, *, tiles_x: int, cfg,
                    n_tiles_per_image: int = 0, has_dlim: bool = True):
    """The inputs of `composite_fwd` on half-size tiles: (geom, feat,
    counts, dlim, kw) with 4 T tiles, each quadrant's tile holding its
    tile's splats (the same capacity K) and, with a limit, its quadrant
    of the depth limits; kw the wrapper's keywords."""
    ts = cfg.tile_size
    if ts % 2:
        raise ValueError(f"tile_size {ts} has no quadrants")
    T = geom.shape[0]
    idx = _quadrant_index(T, tiles_x, n_tiles_per_image, geom.device)
    order = torch.argsort(idx.reshape(-1))
    src = order // 4     # the tile each half-size tile copies

    def take(x):
        return x[src].contiguous()

    d = None
    if has_dlim:
        d = _quadrants(dlim.transpose(1, 2), ts).reshape(4 * T, 1, -1)
        d = d[order].transpose(1, 2).contiguous()
    kw = dict(tiles_x=2 * tiles_x,
              cfg=dataclasses.replace(cfg, tile_size=ts // 2),
              n_tiles_per_image=4 * n_tiles_per_image, has_dlim=has_dlim)
    return take(geom), take(feat), take(counts), d, kw


def quadrant_diffs(full, half, *, tiles_x: int, cfg,
                   n_tiles_per_image: int = 0, **_) -> dict:
    """Largest differences between the forward on tiles (`full`) and on
    their quadrants (`half`), both composite_fwd's 4 outputs: out on
    every pixel, log_t_final on each quadrant whose nblk equals its
    tile's, log_t_groups on the groups of the batches both processed;
    nblk_over counts tiles whose nblk is not the largest of their
    quadrants'; tiles_equal the quadrants whose nblk is their tile's."""
    out, tfin, nblk, ltg = full
    hout, htfin, hnblk, hltg = half
    ts = cfg.tile_size
    T = out.shape[0]
    idx = _quadrant_index(T, tiles_x, n_tiles_per_image, out.device)
    qn = hnblk[idx].long()                            # (T, 4)
    over = int((qn.amax(dim=1) != nblk.long()).sum())
    same = qn == nblk.long()[:, None]

    def gap(a, b):
        return float((a - b).abs().max()) if a.numel() else 0.0

    out_d = gap(_quadrants(out, ts), hout[idx])
    lt_d = gap(_quadrants(tfin.transpose(1, 2), ts)[same],
               htfin[idx].transpose(2, 3)[same])
    both = torch.minimum(qn, nblk.long()[:, None]) * (BK // LT_GROUP)
    g = torch.arange(ltg.shape[1], device=out.device)
    done = g[None, None, :] < both[:, :, None]        # (T, 4, groups)
    ltg_d = gap(_quadrants(ltg, ts)[done], hltg[idx][done])
    return dict(out=out_d, log_t_final=lt_d, log_t_groups=ltg_d,
                nblk_over=over, tiles_equal=int(same.sum()))


def forward_diffs(a, b) -> dict:
    """Largest differences between two of composite_fwd's 4 outputs on the
    same tiles: out, log_t_final and nblk everywhere, log_t_groups on the
    groups of the batches both processed (the rest is never written)."""
    def gap(x, y):
        return float((x - y).abs().max()) if x.numel() else 0.0

    both = torch.minimum(a[2], b[2]).long() * (BK // LT_GROUP)
    g = torch.arange(a[3].shape[1], device=a[3].device)
    done = g[None, :] < both[:, None]                 # (T, groups)
    return dict(out=gap(a[0], b[0]), log_t_final=gap(a[1], b[1]),
                nblk=gap(a[2].long(), b[2].long()),
                log_t_groups=gap(a[3][done], b[3][done]))
