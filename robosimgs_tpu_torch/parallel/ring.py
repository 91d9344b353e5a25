"""Ring-streamed gaussian-sharded tile gathering (the ppermute ring).

A port of robosimgs_tpu/parallel/ring.py. The Gaussian set lives sharded
over the 'data' group and is never whole on any rank: each rank's shard
of raw parameters rotates around the ring (comm.rotate); at every hop a
rank projects the visiting chunk with its row-strip crop camera, bins it
with the packed binner (render/binning.py, return_sel) and merges the
chunk's per-tile candidates into a carried (T, K) top-K buffer ordered
by (depth, global id).

Top-K by a total order is associative, and (depth, global id) is the
stable depth-argsort order of the all_gather path, so the merged (geom,
feat, counts) are the blocks binning the whole set gives, while a rank
holds O(N / n_shard + T K).

The backward replays the revolution instead of saving the visiting
chunks: the merged (T, K) global ids tell which output slots each chunk
owns; (chunk, gradient accumulator) pairs rotate one full revolution,
at each hop pulling the masked output cotangent through that chunk's
project -> pack16 -> row gather with torch.autograd.grad, and one last
hop brings each accumulator home to its shard.

Truncation accounting: per-chunk BinStats are summed over hops and the
merge's drops (per-tile sums of chunk counts beyond K) are folded into
overflowed_tiles / max_tile_count: an upper bound, zero exactly when
nothing anywhere was dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.core.types import Gaussians
from robosimgs_tpu_torch.parallel import comm
from robosimgs_tpu_torch.render.binning import (BinStats,
                                                bin_and_gather_packed, pack16)
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.project import project
from robosimgs_tpu_torch.render.tiled import composite_from_tiles
from robosimgs_tpu_torch.train.optim import FLOAT_FIELDS

BIG_GID = 2 ** 30


def _pack(params: Dict[str, torch.Tensor], offset: torch.Tensor,
          alive: torch.Tensor) -> Tuple[torch.Tensor, List[int]]:
    """One (nc, D) float tensor of a chunk (what rotates: one message a
    hop) — the float fields, the offset and alive as 0/1 — and the
    column widths."""
    cols = [params[k].reshape(params[k].shape[0], -1) for k in FLOAT_FIELDS]
    cols += [offset, alive.to(offset.dtype)[:, None]]
    return torch.cat(cols, dim=1), [c.shape[1] for c in cols]


def _unpack(flat: torch.Tensor, widths: List[int],
            shapes: Dict[str, torch.Size]):
    """(params, offset, alive) of a packed chunk."""
    parts = torch.split(flat, widths, dim=1)
    params = {k: p.reshape((-1,) + tuple(shapes[k][1:]))
              for k, p in zip(FLOAT_FIELDS, parts)}
    return params, parts[-2], parts[-1][:, 0] > 0.5


def _chunk_project(params, alive, offset, cam, cfg: RenderConfig):
    crop, thf = cam
    p = Gaussians(**params, alive=alive)
    return project(p, crop, cfg, means2d_offset=offset, tan_half_fov=thf)


def _chunk_tiles(params, alive, offset, gid0: int, cam, width: int,
                 rows: int, cfg: RenderConfig):
    """Project + bin one visiting chunk for this rank's row strip:
    (payload (T, 16, K), keys (T, K) depth, gids (T, K) global id,
    counts (T,), stats, (radii, valid))."""
    proj = _chunk_project(params, alive, offset, cam, cfg)
    geom, feat, counts, stats, sel = bin_and_gather_packed(
        proj, width, rows, cfg, return_sel=True)
    K = cfg.tile_capacity
    kmask = torch.arange(K, device=geom.device)[None, :] < counts[:, None]
    keys = torch.where(kmask, geom[:, 6, :], torch.inf)   # sg(depth) row
    gids = torch.where(kmask, gid0 + sel, BIG_GID)
    payload = torch.cat([geom, feat], dim=1)
    return payload, keys, gids, counts, stats, (proj.radii, proj.valid)


def _order_key(keys: torch.Tensor, gids: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as (depth, gid): the f32's order-preserving
    int32 image in the high bits, the gid (< 2^31) in the low 31."""
    bits = keys.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (ordered.to(torch.int64) << 31) | gids.to(torch.int64)


def _merge_topk(keys_a, gids_a, pay_a, keys_b, gids_b, pay_b, K: int):
    """The first K entries of two per-tile candidate sets by (depth, gid)
    — the stable depth-argsort order. Valid (depth, gid) pairs are
    unique (a Gaussian enters a tile once and lives in one chunk), so
    ties are between inert padding only."""
    keys2 = torch.cat([keys_a, keys_b], dim=1)              # (T, 2K)
    gids2 = torch.cat([gids_a, gids_b], dim=1)
    idx = torch.sort(_order_key(keys2, gids2), dim=1, stable=True
                     ).indices[:, :K]
    pay2 = torch.cat([pay_a, pay_b], dim=2)                 # (T, 16, 2K)
    pay = torch.gather(pay2, 2, idx[:, None, :].expand(-1, pay2.shape[1], -1))
    return torch.gather(keys2, 1, idx), torch.gather(gids2, 1, idx), pay


class _RingBinGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, alive, cam, width, rows, cfg, group, offset, *fields):
        n = dist.get_world_size(group)
        shard = dist.get_rank(group)
        nc = alive.shape[0]
        K = cfg.tile_capacity
        params = dict(zip(FLOAT_FIELDS, fields))
        shapes = {k: v.shape for k, v in params.items()}

        pay, keys, gids, csum, st, (radii0, valid0) = _chunk_tiles(
            params, alive, offset, shard * nc, cam, width, rows, cfg)
        acc = [st.truncated_gaussians, st.overflowed_tiles,
               st.max_tile_count, st.total_pairs]
        flat, widths = _pack(params, offset, alive)
        for h in range(1, n):
            (flat,) = comm.rotate([flat], group)
            cparams, coff, calive = _unpack(flat, widths, shapes)
            gid0 = ((shard - h) % n) * nc
            pay_c, keys_c, gids_c, counts_c, st_c, _ = _chunk_tiles(
                cparams, calive, coff, gid0, cam, width, rows, cfg)
            keys, gids, pay = _merge_topk(keys, gids, pay,
                                          keys_c, gids_c, pay_c, K)
            csum = csum + counts_c
            acc = [acc[0] + st_c.truncated_gaussians,
                   acc[1] + st_c.overflowed_tiles,
                   torch.maximum(acc[2], st_c.max_tile_count),
                   acc[3] + st_c.total_pairs]

        counts = torch.clamp_max(csum, K).to(torch.int32)
        overflowed = acc[1] + (csum > K).sum()
        max_count = torch.maximum(acc[2], csum.max().to(acc[2].dtype))
        ctx.save_for_backward(alive, offset, gids, counts, *fields)
        ctx.meta = (cam, cfg, group, widths, shapes)
        ctx.mark_non_differentiable(counts, radii0, valid0)
        return (pay[:, :8].contiguous(), pay[:, 8:].contiguous(), counts,
                acc[0], overflowed, max_count, acc[3], radii0, valid0)

    @staticmethod
    def backward(ctx, d_geom, d_feat, *_rest):
        alive, offset, gids, counts, *fields = ctx.saved_tensors
        cam, cfg, group, widths, shapes = ctx.meta
        n = dist.get_world_size(group)
        shard = dist.get_rank(group)
        nc = alive.shape[0]
        K = cfg.tile_capacity
        kmask = torch.arange(K, device=gids.device)[None, :] < counts[:, None]
        ct = torch.where(kmask[:, None, :], torch.cat([d_geom, d_feat], 1),
                         0.0).transpose(1, 2)                 # (T, K, 16)

        def chunk_grad(flat, hop):
            """Gradient of (project -> pack16 -> row gather at the
            chunk's output slots) against the cotangent, packed as the
            chunk is; the top-K merge is pure routing, held by `mine`."""
            gid0 = ((shard - hop) % n) * nc
            mine = (gids >= gid0) & (gids < gid0 + nc)
            local = torch.where(mine, gids - gid0, 0)
            with torch.enable_grad():
                leaf = flat.detach().requires_grad_(True)
                cparams, coff, calive = _unpack(leaf, widths, shapes)
                proj = _chunk_project(cparams, calive, coff, cam, cfg)
                gath = pack16(proj)[local]                   # (T, K, 16)
                s = torch.sum(torch.where(mine[..., None], gath, 0.0) * ct)
                return torch.autograd.grad(s, leaf)[0]

        flat, _ = _pack(dict(zip(FLOAT_FIELDS, fields)), offset, alive)
        gacc = chunk_grad(flat, 0)
        for h in range(1, n):
            flat, gacc = comm.rotate([flat, gacc], group)
            gacc = gacc + chunk_grad(flat, h)
        # one last hop completes the revolution: gradients arrive home
        (gacc,) = comm.rotate([gacc], group)
        d_params, d_offset, _ = _unpack(gacc, widths, shapes)
        return (None, None, None, None, None, None, d_offset,
                *[d_params[k] for k in FLOAT_FIELDS])


def ring_bin_gather(params: Dict[str, torch.Tensor], alive: torch.Tensor,
                    offset: torch.Tensor, cam, width: int, rows: int,
                    cfg: RenderConfig, group):
    """Ring-streamed bin + gather over the process group `group` (the
    'data' line of this rank).

    params / alive / offset are this rank's LOCAL shard (the float
    fields of `float_params`, (nc,) bool, (nc, 2)); cam is (crop Camera,
    full-frame tan_half_fov) of this rank's row strip. Returns (geom
    (T, 8, K), feat (T, 8, K), counts (T,), stats, radii, valid): the
    first four as `bin_and_gather_packed` gives them on the whole
    projected set, radii / valid (nc,) the local shard's from its hop-0
    visit, detached (the densify side channel)."""
    (geom, feat, counts, trunc, over, max_count, pairs, radii,
     valid) = _RingBinGather.apply(alive, cam, width, rows, cfg, group,
                                   offset, *[params[k] for k in FLOAT_FIELDS])
    stats = BinStats(truncated_gaussians=trunc, overflowed_tiles=over,
                     max_tile_count=max_count, total_pairs=pairs)
    return geom, feat, counts, stats, radii, valid


def crop_camera_rows(cam: Camera, row0: int, rows: int) -> Camera:
    """The camera of rows [row0, row0 + rows) of cam's frame: cy shifted.
    Project it with the full frame's tan_half_fov."""
    return dataclasses.replace(cam, cy=cam.cy - row0, height=rows)


def ring_render_rows(params: Dict[str, torch.Tensor], alive: torch.Tensor,
                     offset: torch.Tensor, camera: Camera, tile_rank: int,
                     n_tile: int, cfg: RenderConfig,
                     background: torch.Tensor, group) -> Dict:
    """Render this tile rank's row strip against the whole ring-streamed
    Gaussian set: crop camera + ring_bin_gather + composite_from_tiles.
    The dict also carries "stats" and the local shard's hop-0 "radii" /
    "valid" (see ring_bin_gather). The ring's project() carries no
    absgrad probe, so with cfg.render_normals the feat rows 5/6/7 hold
    full xyz normals and "normal" is emitted."""
    rows = camera.height // n_tile
    crop = crop_camera_rows(camera, tile_rank * rows, rows)
    geom, feat, counts, stats, radii, valid = ring_bin_gather(
        params, alive, offset, (crop, camera.tan_half_fov), camera.width,
        rows, cfg, group)
    out = composite_from_tiles(geom, feat, counts, camera.width, rows, cfg,
                               background,
                               normal_mode=("xyz" if cfg.render_normals
                                            else "none"))
    out["stats"] = stats
    out["radii"] = radii
    out["valid"] = valid
    return out
