"""Tile binning: per-tile, depth-ordered gathered splat blocks.

Port of robosimgs_tpu/render/binning.py's packed path
(`bin_and_gather_packed`): Gaussians are permuted into global depth
order, each one enumerates the tiles of its radius bbox (at most
`bbox_tiles_per_gaussian`), an exact ellipse-tile cull drops tiles it
cannot reach, and one sort of (tile id, depth rank) keys groups the
survivors by tile in front-to-back order. Each tile keeps its closest
`tile_capacity` entries; truncation and overflow are counted in
`BinStats`, never silent.

Outputs are identical to the JAX package's wherever its path is exact.
Differences of form: the key is int64 (tile id << rank bits | rank), so
the packed single-key sort always applies; the per-tile windows are one
index gather; the two-tier spill takes the widest gaussians with a
stable descending sort (lowest index first among equal covers).

`bin_rects` is the generic binner for any rect-bounded primitive (the
mesh rasterizer's triangles), and `per_gaussian_cover` counts the tiles
each splat reaches after the exact cull (capacity autotuning).
`bin_gaussians` + `gather_tile_features` are the JAX package's unpacked
binner (bbox tiles only, one take per feature row), which
`render/tiled.py::composite_from_tiles` composites as it does the packed
blocks.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.project import Projected
from robosimgs_tpu_torch.render.tiles import num_tiles, tile_bbox
from robosimgs_tpu_torch.utils.profiling import count, recording, span


@dataclasses.dataclass
class BinStats:
    """Truncation accounting (0-d int64 tensors)."""

    truncated_gaussians: torch.Tensor  # gaussians covering > max_tiles tiles
    overflowed_tiles: torch.Tensor     # tiles with more than capacity entries
    max_tile_count: torch.Tensor       # max entries wanted by any tile
    total_pairs: torch.Tensor          # total (gaussian, tile) intersections


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


def bin_rects(tx0: torch.Tensor, ty0: torch.Tensor, tx1: torch.Tensor,
              ty1: torch.Tensor, rank: torch.Tensor, valid: torch.Tensor,
              tiles_x: int, tiles_y: int, max_tiles_per_prim: int,
              tile_capacity: int):
    """Generic tile binner for rect-bounded primitives: (sel (T, K) int64
    primitive indices ordered by `rank` within each tile, 0 past the
    count; counts (T,) int32; stats). tx0..ty1 are each primitive's
    inclusive tile bbox (tx1 < tx0 when empty), rank (n,) its order in
    [0, n), distinct within a tile. A primitive enumerates at most
    max_tiles_per_prim tiles (row-major; the rest are counted as
    truncated) and a tile keeps its first tile_capacity entries (the rest
    counted as overflow). The JAX package sorts (tile, rank, id) with one
    two-key sort; here one stable sort of the int64 key tile << bits |
    rank, whose permutation gives the ids."""
    T = tiles_x * tiles_y
    n = tx0.shape[0]
    M, K = max_tiles_per_prim, tile_capacity
    dev = tx0.device
    tid, _, _, in_bbox, cover = _bbox_slots(tx0, ty0, tx1, ty1, M, tiles_x)
    tid = torch.where(in_bbox & valid[:, None], tid, torch.full_like(tid, T))
    bits = max(1, (n - 1).bit_length())
    key = ((tid << bits) | rank.long()[:, None]).reshape(-1)
    s_key, perm = torch.sort(key, stable=True)
    L = key.shape[0]
    bounds = torch.searchsorted(s_key, torch.arange(T + 1, device=dev) << bits)
    s_id = torch.cat([torch.div(perm, M, rounding_mode="floor"),
                      torch.zeros((K,), dtype=perm.dtype, device=dev)])
    k_ar = torch.arange(K, device=dev)
    full_counts = bounds[1:] - bounds[:-1]
    counts = torch.clamp_max(full_counts, K)
    sel = s_id[torch.clamp_max(bounds[:-1], L)[:, None] + k_ar[None, :]]
    sel = torch.where(k_ar[None, :] < counts[:, None], sel,
                      torch.zeros_like(sel))
    stats = BinStats(
        truncated_gaussians=((cover > M) & valid).sum(),
        overflowed_tiles=(full_counts > K).sum(),
        max_tile_count=full_counts.max(),
        total_pairs=torch.where(valid, torch.clamp_max(cover, M),
                                torch.zeros_like(cover)).sum(),
    )
    return sel, counts.to(torch.int32), stats


def per_gaussian_cover(proj: Projected, width: int, height: int,
                       cfg: RenderConfig, max_tiles: int) -> torch.Tensor:
    """(N,) int32: the tiles each gaussian reaches after the exact cull
    (its bbox cover when exact_tile_cull is off), enumerating up to
    max_tiles bbox tiles. Autotuning sizes max_tiles_per_gaussian from
    it (the cull drops bbox corner tiles, so the needed M is smaller
    than the bbox cover)."""
    tiles_x, tiles_y = num_tiles(width, height, cfg.tile_size)
    zero = torch.zeros((), dtype=proj.means2d.dtype, device=proj.means2d.device)
    radii = torch.where(proj.valid, proj.radii.to(zero.dtype), zero)
    tx0, ty0, tx1, ty1 = tile_bbox(proj.means2d, radii, tiles_x, tiles_y,
                                   cfg.tile_size)
    _, row, col, keep, _ = _bbox_slots(tx0, ty0, tx1, ty1, max_tiles, tiles_x)
    keep = keep & (radii > 0.0)[:, None]
    if cfg.exact_tile_cull:
        cop = torch.stack([proj.conics[:, 0], proj.conics[:, 1],
                           proj.conics[:, 2],
                           torch.where(proj.valid, proj.opacities, zero)],
                          dim=1).detach()
        keep = keep & _cull_keep(proj.means2d.detach(), cop, tx0, ty0, col,
                                 row, cfg.tile_size, cfg.alpha_min)
    return keep.sum(dim=1).to(torch.int32)


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
    ts_f = float(tile_size)
    ca, cb, cc, op = (cop[:, 0:1], cop[:, 1:2], cop[:, 2:3], cop[:, 3:4])
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
    qcut = torch.log(torch.clamp_min(op, 1e-12) / alpha_min)
    # cull only with a definitely-PSD conic (conservative otherwise)
    psd = (ca > 0.0) & (cc > 0.0)
    return ~psd | (qmin <= qcut)


def pack16(proj: Projected) -> torch.Tensor:
    """The (N, 16) per-gaussian feature matrix consumed by the tile
    compositors: columns 0..7 are the geom rows [mx, my, conic_a/b/c,
    opacity, sg(depth), probe_x], columns 8..15 the feat rows [r, g, b,
    depth, 1, nx, ny, nz | probe_y]. The absgrad probe columns are zeros
    as values; normals ride the free feat rows 5/6 (and 7 unless the
    probe owns it)."""
    zeros = torch.zeros_like(proj.depths)
    ones = torch.ones_like(proj.depths)
    mask_f = proj.valid.to(proj.depths.dtype)
    px = proj.abs_probe[:, 0] if proj.abs_probe is not None else zeros
    py_ = proj.abs_probe[:, 1] if proj.abs_probe is not None else zeros
    n13 = proj.normals[:, 0] if proj.normals is not None else zeros
    n14 = proj.normals[:, 1] if proj.normals is not None else zeros
    c15 = py_
    if proj.normals is not None and proj.abs_probe is None:
        c15 = proj.normals[:, 2]
    return torch.stack([
        proj.means2d[:, 0], proj.means2d[:, 1],
        proj.conics[:, 0], proj.conics[:, 1], proj.conics[:, 2],
        proj.opacities * mask_f,
        proj.depths.detach(), px,
        proj.colors[:, 0], proj.colors[:, 1], proj.colors[:, 2],
        proj.depths, ones, n13, n14, c15,
    ], dim=1)


class _GatherRows(torch.autograd.Function):
    """packed[sel] (the (T, K) gather of the packed binner), whose
    backward sums each Gaussian's gradient rows over its kept entries.
    pos (n, M): rank r's entries' positions in the flattened (T, K), T*K
    (a zero row) where not kept, in ascending order (its tiles ascend),
    which is the order in which autograd's own transpose (index_put_
    with accumulate) adds them, so the sums are the same bits. That
    transpose also adds every padding slot's zero into order[0]'s row,
    one after another (~0.2-0.3 us a slot on an H100), which dominates a
    step whose tiles are mostly padding; here the padding slots are
    never read."""

    @staticmethod
    def forward(ctx, packed, sel, order, pos):
        ctx.save_for_backward(order, pos)
        return packed[sel]

    @staticmethod
    @span("bin.gather_bwd")
    def backward(ctx, grad):
        order, pos = ctx.saved_tensors
        rows = torch.cat([grad.reshape(-1, grad.shape[-1]),
                          grad.new_zeros((1, grad.shape[-1]))])
        acc = torch.zeros((pos.shape[0], rows.shape[1]), dtype=rows.dtype,
                          device=rows.device)
        for m in range(pos.shape[1]):
            acc = acc + rows[pos[:, m]]
        out = torch.empty_like(acc)
        out[order] = acc
        return out, None, None, None


def bin_and_gather_packed(proj: Projected, width: int, height: int,
                          cfg: RenderConfig, return_sel: bool = False):
    """Bin splats into tiles and gather each tile's depth-ordered rows.

    Returns (geom (T,8,K), feat (T,8,K), counts (T,) int32, stats), both
    blocks contiguous; with return_sel also the (T, K) int64
    ORIGINAL-index selection matrix. Entries past counts[t] are padding
    with opacity 0 (inert in every compositor).
    """
    tiles_x, tiles_y = num_tiles(width, height, cfg.tile_size)
    T = tiles_x * tiles_y
    n = proj.means2d.shape[0]
    M = cfg.max_tiles_per_gaussian
    K = cfg.tile_capacity
    dev = proj.means2d.device

    packed = pack16(proj)
    zero = torch.zeros((), dtype=proj.means2d.dtype, device=dev)
    valid = proj.valid
    with span("bin.depth_order"):
        bbox_in = torch.stack([
            proj.means2d[:, 0], proj.means2d[:, 1],
            torch.where(valid, proj.radii.to(zero.dtype), zero),
            proj.conics[:, 0], proj.conics[:, 1], proj.conics[:, 2],
            torch.where(valid, proj.opacities, zero),
        ], dim=1).detach()  # (N, 7); cols 3..6 feed the exact cull
        # global front-to-back permutation (stable, like jnp.argsort)
        inf = torch.full_like(proj.depths, math.inf)
        order = torch.argsort(torch.where(valid, proj.depths.detach(), inf),
                              stable=True)
        bbox_s = bbox_in[order]
    m2d_s = bbox_s[:, 0:2]
    radii_s = bbox_s[:, 2]

    with span("bin.cull"):
        valid_s = radii_s > 0.0
        tx0, ty0, tx1, ty1 = tile_bbox(m2d_s, radii_s, tiles_x, tiles_y,
                                       cfg.tile_size)
        # enumerate Mb bbox tiles; after the cull, survivors are
        # compacted down to M slots by a row-local sort (sentinel T
        # sorts last)
        Mb = max(cfg.bbox_tiles_per_gaussian, M)
        tid, row, col, in_bbox, cover = _bbox_slots(tx0, ty0, tx1, ty1, Mb,
                                                    tiles_x)
        valid_e = in_bbox & valid_s[:, None]
        if cfg.exact_tile_cull:
            valid_e = valid_e & _cull_keep(
                m2d_s, bbox_s[:, 3:7], tx0, ty0, col, row,
                cfg.tile_size, cfg.alpha_min)
        tid = torch.where(valid_e, tid, torch.full_like(tid, T))
        surv = valid_e.sum(dim=1)                          # per-gaussian cover

    Ms = cfg.two_tier_split
    two_tier = 0 < Ms < M
    with span("bin.compact", device_time=True):
        if Mb > M:
            tid = torch.sort(tid, dim=1).values[:, :M]
        elif two_tier:
            # two-tier needs sentinels at the row tail (the cull leaves
            # holes)
            tid = torch.sort(tid, dim=1).values

    # entries are depth-ordered (rank = row index), so sorting the
    # int64 key (tid << bits | rank) groups by tile, front to back
    bits = max(1, (n - 1).bit_length())
    with span("bin.key_sort", device_time=True):
        rank = torch.arange(n, device=dev)
        spill_missed = torch.zeros((n,), dtype=torch.bool, device=dev)
        spill_dropped_pairs = 0
        if two_tier:
            # tier 1: everyone's first Ms (row-sorted) slots; tier 2: the
            # S widest gaussians contribute slots Ms..M (rows that don't
            # actually spill contribute inert sentinel keys)
            S = min(n, max(128, -(-int(cfg.two_tier_spill_frac * n) // 128)
                           * 128))
            key1 = (tid[:, :Ms] << bits) | rank[:, None]
            spill = torch.sort(surv, descending=True, stable=True)
            spill_cover, spill_idx = spill.values[:S], spill.indices[:S]
            key2 = (tid[:, Ms:][spill_idx] << bits) | spill_idx[:, None]
            packed_key = torch.cat([key1.reshape(-1), key2.reshape(-1)])
            need = (torch.clamp_max(surv, M) - Ms).clamp_min(0).sum()
            got = (torch.clamp_max(spill_cover, M) - Ms).clamp_min(0).sum()
            spill_dropped_pairs = need - got
            # index_fill_ takes True as a kernel argument (an indexed
            # assignment copies it from the host, which a CUDA graph
            # refuses)
            in_spill = torch.zeros((n,), dtype=torch.bool,
                                   device=dev).index_fill_(0, spill_idx, True)
            spill_missed = (surv > Ms) & ~in_spill
        else:
            packed_key = ((tid << bits) | rank[:, None]).reshape(-1)
        L = packed_key.shape[0]
        s_key, s_perm = torch.sort(packed_key)
        # per-tile bounds: the first key at or past (tile << bits)
        bounds = torch.searchsorted(
            s_key, torch.arange(T + 1, device=dev) << bits)

    with span("bin.gather"):
        # each tile's K candidates are contiguous in the sorted keys: one
        # (T, K) index gather of the padded key array
        s_key_pad = torch.cat([s_key, torch.full((K,), (T + 1) << bits,
                                                 device=dev)])
        k_ar = torch.arange(K, device=dev)
        win = s_key_pad[torch.clamp_max(bounds[:-1], L)[:, None]
                        + k_ar[None, :]]
        sel_rank = win & ((1 << bits) - 1)

        full_counts = bounds[1:] - bounds[:-1]
        counts = torch.clamp_max(full_counts, K)

        kmask = k_ar[None, :] < counts[:, None]
        sel = order[torch.where(kmask, sel_rank, torch.zeros_like(sel_rank))]

        if packed.requires_grad:
            # each entry's (tile, slot) position in the (T, K) blocks, T*K
            # where it is a sentinel or past its tile's capacity
            j = torch.arange(L, device=dev)
            s_tile = s_key >> bits
            slot = j - bounds[torch.clamp_max(s_tile, T)]
            flat = torch.where((s_tile < T) & (slot < K), s_tile * K + slot,
                               T * K)
            flat = torch.empty_like(flat).scatter_(0, s_perm, flat)
            if two_tier:
                pos = torch.full((n, M), T * K, dtype=flat.dtype, device=dev)
                pos[:, :Ms] = flat[:n * Ms].view(n, Ms)
                pos[spill_idx, Ms:] = flat[n * Ms:].view(-1, M - Ms)
            else:
                pos = flat.view(n, -1)
            gathered = _GatherRows.apply(packed, sel, order, pos)
        else:
            gathered = packed[sel]                       # (T, K, 16)
        # padding entries must be inert: zero their opacity column
        op = torch.where(kmask, gathered[:, :, 5],
                         torch.zeros_like(gathered[:, :, 5]))
        gathered = torch.cat([gathered[:, :, :5], op[:, :, None],
                              gathered[:, :, 6:]], dim=2)
        gathered = gathered.transpose(1, 2)              # (T, 16, K)
        geom = gathered[:, :8].contiguous()
        feat = gathered[:, 8:].contiguous()

    stats = BinStats(
        truncated_gaussians=(
            valid_s & ((cover > Mb) | (surv > M) | spill_missed)).sum(),
        overflowed_tiles=(full_counts > K).sum(),
        max_tile_count=full_counts.max(),
        total_pairs=torch.clamp_max(surv, M).sum() - spill_dropped_pairs,
    )
    if recording():
        # how much of each sort is real work: slots kept by the cull of
        # those enumerated, keys of a tile of those sorted (the kept
        # slots' sum is the one reduction counting launches)
        count("bin.slots", n * Mb)
        count("bin.slots_kept", surv.sum())
        count("bin.keys_sorted", L)
        count("bin.keys_real", bounds[-1])
        count("bin.truncated", stats.truncated_gaussians)
        count("bin.overflowed_tiles", stats.overflowed_tiles)
    counts = counts.to(torch.int32)
    if return_sel:
        return geom, feat, counts, stats, sel
    return geom, feat, counts, stats


def bin_gaussians(proj: Projected, width: int, height: int,
                  cfg: RenderConfig):
    """The unpacked binner: (sel (T, K) int64 per-tile Gaussian indices,
    front to back, 0 past the count; counts (T,) int32; stats).

    Every Gaussian enumerates the tiles of its radius bbox (at most
    max_tiles_per_gaussian, no exact cull and no two-tier split) and
    `bin_rects` orders each tile by the global depth rank of one stable
    argsort. `gather_tile_features` turns sel into the kernels' blocks."""
    tiles_x, tiles_y = num_tiles(width, height, cfg.tile_size)
    n = proj.means2d.shape[0]
    tx0, ty0, tx1, ty1 = tile_bbox(proj.means2d.detach(),
                                   proj.radii.detach(), tiles_x, tiles_y,
                                   cfg.tile_size)
    inf = torch.full_like(proj.depths, math.inf)
    order = torch.argsort(torch.where(proj.valid, proj.depths.detach(), inf),
                          stable=True)
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=order.device))
    return bin_rects(tx0, ty0, tx1, ty1, rank, proj.valid, tiles_x, tiles_y,
                     cfg.max_tiles_per_gaussian, cfg.tile_capacity)


def gather_tile_features(proj: Projected, sel: torch.Tensor,
                         counts: torch.Tensor, cfg: RenderConfig):
    """Per-tile blocks for the composite kernels from `bin_gaussians`'
    selection, one row take per field:

      geom (T, 8, K): [mx, my, conic_a, conic_b, conic_c, opacity,
                       depth (no gradient), 0]
      feat (T, 8, K): [r, g, b, depth, 1, nx, ny, nz]

    Padding entries (past counts) get opacity 0, inert in the forward
    and the backward. The normal rows are zeros without normals; row 7
    stays 0 when the absgrad probe owns it (as in `pack16`). Gradients
    reach proj.* through autograd's transposes of the takes."""
    K = sel.shape[1]
    mask = torch.arange(K, device=sel.device)[None, :] < counts[:, None]
    mx = proj.means2d[sel, 0]
    my = proj.means2d[sel, 1]
    ca = proj.conics[sel, 0]
    cb = proj.conics[sel, 1]
    cc = proj.conics[sel, 2]
    zeros = torch.zeros_like(mx)
    op = torch.where(mask, proj.opacities[sel], zeros)
    gd = proj.depths.detach()[sel]
    geom = torch.stack([mx, my, ca, cb, cc, op, gd, zeros], dim=1)

    r = proj.colors[sel, 0]
    g = proj.colors[sel, 1]
    b = proj.colors[sel, 2]
    d = proj.depths[sel]
    ones = torch.ones_like(r)
    n5 = proj.normals[sel, 0] if proj.normals is not None else zeros
    n6 = proj.normals[sel, 1] if proj.normals is not None else zeros
    f7 = zeros
    if proj.normals is not None and proj.abs_probe is None:
        f7 = proj.normals[sel, 2]
    feat = torch.stack([r, g, b, d, ones, n5, n6, f7], dim=1)
    return geom, feat
