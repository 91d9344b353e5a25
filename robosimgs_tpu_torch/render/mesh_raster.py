"""Triangle mesh rasterizer (plain torch, tile-binned z-buffer).

A port of robosimgs_tpu/render/mesh_raster.py: triangles are projected
with the splat renderer's camera and pixel conventions, clipped against
the near plane, binned to 16x16 tiles with the generic rect binner, and
each pixel keeps its nearest triangle by perspective-correct 1/z
interpolation. Returns rgb/depth/mask/face_id; the depth is the
per-pixel occlusion limit of the depth-merged splat + mesh compositor
(render/compose.py). The JAX package has no Pallas kernel here, so this
is torch ops on the vertices' device; vertices stay differentiable.

Where the JAX package maps a function over every tile (skipping empty
ones with a cond), the port computes the non-empty tiles at once, in
groups whose (tiles, pixels, candidates) temporaries stay within
`_GROUP_ELEMS` elements (more on the card, where each group costs a few
dozen kernel launches); sizing them costs one host sync per call. The
candidate lists are cut at the largest count among the non-empty tiles,
which changes nothing: past its count a candidate is masked.
Meshes are numpy on both sides (utils/meshio.py), so no converter is
needed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.render.binning import bin_rects
from robosimgs_tpu_torch.render.gathered import tile_pixel_coords, untile
from robosimgs_tpu_torch.render.tiles import num_tiles
from robosimgs_tpu_torch.utils.profiling import count, span

# elements of one (tiles, pixels, candidates) temporary per group; about
# a dozen such temporaries are alive at once
_GROUP_ELEMS = {"cuda": 1 << 26, "cpu": 1 << 24}


@dataclasses.dataclass(frozen=True)
class MeshRasterConfig:
    tile_size: int = 16
    max_tiles_per_tri: int = 128
    tile_capacity: int = 512
    near: float = 0.01
    # clip triangles straddling the near plane into <=2 sub-triangles
    # (every face gets two output slots, the second degenerate unless
    # clipping splits a quad). Off = drop straddling triangles whole and
    # count them.
    clip_near: bool = True
    # candidate-chunked z-buffering: stream each tile's candidates in
    # chunks of tri_chunk, carrying only the per-pixel running (depth,
    # winner), so the temporaries scale with the chunk and not with
    # tile_capacity. 0 = unchunked.
    tri_chunk: int = 0


def _clip_near_plane(tri, attr, near: float):
    """Clip camera-space triangles against z = near.

    tri (F, 3, 3) camera-space vertices; attr (F, 3, C) per-vertex
    attributes interpolated at clip points. Returns (tri2 (2F, 3, 3),
    attr2 (2F, 3, C), valid (2F,) bool, src (2F,) int64 original face).

    Canonicalized by cyclic rotation (winding-preserving): one-in-front
    clips to a single triangle, two-in-front to a quad = two triangles;
    fully-behind faces come back invalid.
    """
    F = tri.shape[0]
    eps = 1e-4
    znear = near * (1.0 + eps)   # strictly in front of the cull test
    d = tri[:, :, 2] - znear     # (F, 3)
    front = d > 0.0
    k = front.sum(-1)            # in-front count per face

    # rotate so: k==1 -> the front vertex at slot 0; k==2 -> the behind
    # vertex at slot 2 (argmax on ints: the first maximum, as jnp.argmax
    # of a bool array)
    i_front = torch.argmax(front.int(), dim=-1)
    i_back = torch.argmax((~front).int(), dim=-1)
    r = torch.where(k == 1, i_front,
                    torch.where(k == 2, (i_back + 1) % 3, torch.zeros_like(k)))
    idx = (torch.arange(3, device=tri.device)[None, :] + r[:, None]) % 3
    tri_c = torch.take_along_dim(tri, idx[:, :, None], dim=1)
    attr_c = torch.take_along_dim(attr, idx[:, :, None], dim=1)
    d_c = torch.take_along_dim(d, idx, dim=1)

    def lerp(p, q, dp, dq):
        # crossing param; denom > 0 on real crossings, guarded for the
        # degenerate slots that the valid mask discards anyway
        den = dp - dq
        den = torch.where(den.abs() < 1e-20, torch.ones_like(den), den)
        s = (dp / den)[:, None]
        return p + (q - p) * s

    a, b, c = tri_c[:, 0], tri_c[:, 1], tri_c[:, 2]
    aa, ab, ac = attr_c[:, 0], attr_c[:, 1], attr_c[:, 2]
    da, db, dc = d_c[:, 0], d_c[:, 1], d_c[:, 2]

    # k==1 (a front): clip edges ab, ac
    p_ab = lerp(a, b, da, db)
    p_ac = lerp(a, c, da, dc)
    a_ab = lerp(aa, ab, da, db)
    a_ac = lerp(aa, ac, da, dc)
    # k==2 (c behind): clip edges bc, ac
    p_bc = lerp(b, c, db, dc)
    a_bc = lerp(ab, ac, db, dc)

    k2 = (k == 2)[:, None, None]
    k3 = (k == 3)[:, None, None]
    tri1 = torch.where(k3, tri_c,
                       torch.where(k2, torch.stack([a, b, p_bc], dim=1),
                                   torch.stack([a, p_ab, p_ac], dim=1)))
    at1 = torch.where(k3, attr_c,
                      torch.where(k2, torch.stack([aa, ab, a_bc], dim=1),
                                  torch.stack([aa, a_ab, a_ac], dim=1)))
    # second output slot: only the k==2 quad split needs it
    tri2 = torch.stack([a, p_bc, p_ac], dim=1)
    at2 = torch.stack([aa, a_bc, a_ac], dim=1)

    src = torch.arange(F, device=tri.device)
    return (torch.cat([tri1, tri2]), torch.cat([at1, at2]),
            torch.cat([k >= 1, k == 2]), torch.cat([src, src]))


def _sample_texture_image(texture: torch.Tensor, u: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Bilinear (H, W) texture lookup, glTF REPEAT wrap, v down from the
    image top; one whole-image gather outside the tile work."""
    th, tw = texture.shape[0], texture.shape[1]
    x = u * tw - 0.5
    y = v * th - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    # remainder (not fmod): jnp.mod's sign for negative texel indices
    x0i = torch.remainder(x0.int(), tw).long()
    x1i = torch.remainder(x0.int() + 1, tw).long()
    y0i = torch.remainder(y0.int(), th).long()
    y1i = torch.remainder(y0.int() + 1, th).long()
    c00 = texture[y0i, x0i]
    c01 = texture[y0i, x1i]
    c10 = texture[y1i, x0i]
    c11 = texture[y1i, x1i]
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def _barycentric(ax, ay, bx, by, cx, cy, area, px, py):
    """(wa, wb, wc) of pixel centers px/py against screen triangles; area
    is the signed twice-area (0 guarded to 1)."""
    inv_area = 1.0 / torch.where(area == 0, torch.ones_like(area), area)
    wa = ((cx - bx) * (py - by) - (cy - by) * (px - bx)) * inv_area
    wb = ((ax - cx) * (py - cy) - (ay - cy) * (px - cx)) * inv_area
    return wa, wb, 1.0 - wa - wb


def _pack_tiles(col, depth, hit, fid):
    """(G, P, 5) attributes, (G, P) depth/hit/face -> (G, 8, P) rows
    [r, g, b, depth, hit, face id, u, v]; misses are 0, +inf, 0, -1."""
    col = torch.where(hit[..., None], col, torch.zeros_like(col))
    depth = torch.where(hit, depth, torch.full_like(depth, math.inf))
    fid = torch.where(hit, fid, torch.full_like(fid, -1))
    return torch.stack([col[..., 0], col[..., 1], col[..., 2], depth,
                        hit.to(depth.dtype), fid.to(depth.dtype),
                        col[..., 3], col[..., 4]], dim=1)


def _tiles_unchunked(sel, counts, t_idx, tri_uv, tri_invz, tri_attr, area,
                     fid_src, tiles_x, ts):
    """The z-buffer of G tiles with all their candidates at once: sel
    (G, Kc), counts (G,), t_idx (G,) tile indices -> (G, 8, P)."""
    Kc = sel.shape[1]
    px, py = tile_pixel_coords(t_idx, tiles_x, ts)
    px, py = px[:, :, None], py[:, :, None]                  # (G, P, 1)
    uv = tri_uv[sel]                                         # (G, Kc, 3, 2)
    invz = tri_invz[sel]                                     # (G, Kc, 3)
    wa, wb, wc = _barycentric(
        uv[:, None, :, 0, 0], uv[:, None, :, 0, 1], uv[:, None, :, 1, 0],
        uv[:, None, :, 1, 1], uv[:, None, :, 2, 0], uv[:, None, :, 2, 1],
        area[sel][:, None, :], px, py)                       # (G, P, Kc)
    kmask = (torch.arange(Kc, device=sel.device)[None, :]
             < counts[:, None])[:, None, :]
    inside = (wa >= 0) & (wb >= 0) & (wc >= 0) & kmask
    invz_p = (wa * invz[:, None, :, 0] + wb * invz[:, None, :, 1]
              + wc * invz[:, None, :, 2])
    z_p = 1.0 / torch.clamp_min(invz_p, 1e-12)
    z_mask = torch.where(inside & (invz_p > 0), z_p,
                         torch.full_like(z_p, math.inf))
    best = torch.argmin(z_mask, dim=2, keepdim=True)         # first minimum
    depth = torch.gather(z_mask, 2, best)[..., 0]
    hit = torch.isfinite(depth)
    wab = torch.stack([torch.gather(w, 2, best)[..., 0]
                       for w in (wa, wb, wc)], dim=-1)       # (G, P, 3)
    b = best[..., 0]
    attr_best = torch.take_along_dim(tri_attr[sel], b[:, :, None, None], 1)
    invz_best = torch.take_along_dim(invz, b[:, :, None], 1)  # (G, P, 3)
    invz_pix = torch.gather(invz_p, 2, best)[..., 0]
    # perspective-correct attribute interpolation
    col = ((wab * invz_best)[..., None] * attr_best).sum(2) \
        / torch.clamp_min(invz_pix, 1e-12)[..., None]
    fid = torch.take_along_dim(fid_src[sel], b, 1)
    return _pack_tiles(col, depth, hit, fid)


def _tiles_chunked(sel, counts, t_idx, tri_uv, tri_invz, tri_attr, area,
                   fid_src, tiles_x, ts, chunk):
    """The z-buffer of G tiles streaming candidates `chunk` at a time,
    carrying only the per-pixel running (depth, winner); the winner's
    attributes are gathered once per pixel afterwards. An earlier chunk
    wins a tie (strict <), as within a chunk the first minimum does."""
    G, Kc = sel.shape
    F = tri_uv.shape[0]
    adim = tri_attr.shape[-1]
    dev = sel.device
    # one row per clipped triangle: uv(6) invz(3) area(1) attr(3*adim)
    # face id(1)
    packed = torch.cat([tri_uv.reshape(F, 6), tri_invz, area[:, None],
                        tri_attr.reshape(F, 3 * adim),
                        fid_src.to(tri_uv.dtype)[:, None]], dim=1)
    px, py = tile_pixel_coords(t_idx, tiles_x, ts)
    best_z = torch.full(px.shape, math.inf, dtype=packed.dtype, device=dev)
    best_k = torch.zeros(px.shape, dtype=torch.long, device=dev)
    pxc, pyc = px[:, :, None], py[:, :, None]
    for c0 in range(0, Kc, chunk):
        idx = sel[:, c0:c0 + chunk]
        rows = packed[idx][:, None]                          # (G, 1, C, D)
        wa, wb, wc = _barycentric(rows[..., 0], rows[..., 1], rows[..., 2],
                                  rows[..., 3], rows[..., 4], rows[..., 5],
                                  rows[..., 9], pxc, pyc)
        kmask = ((c0 + torch.arange(idx.shape[1], device=dev))[None, :]
                 < counts[:, None])[:, None, :]
        inside = (wa >= 0) & (wb >= 0) & (wc >= 0) & kmask
        invz_p = wa * rows[..., 6] + wb * rows[..., 7] + wc * rows[..., 8]
        z_p = 1.0 / torch.clamp_min(invz_p, 1e-12)
        zm = torch.where(inside & (invz_p > 0), z_p,
                         torch.full_like(z_p, math.inf))
        cz, ca = torch.min(zm, dim=2)                        # first minimum
        better = cz < best_z                  # strict: an earlier chunk wins
        best_z = torch.where(better, cz, best_z)
        best_k = torch.where(better, c0 + ca, best_k)
    hit = torch.isfinite(best_z)
    rows = packed[torch.take_along_dim(sel, best_k, 1)]      # (G, P, D)
    wa, wb, wc = _barycentric(rows[..., 0], rows[..., 1], rows[..., 2],
                              rows[..., 3], rows[..., 4], rows[..., 5],
                              rows[..., 9], px, py)
    invzb = rows[..., 6:9]
    invz_pix = wa * invzb[..., 0] + wb * invzb[..., 1] + wc * invzb[..., 2]
    wab = torch.stack([wa, wb, wc], dim=-1)
    attr = rows[..., 10:10 + 3 * adim].reshape(G, -1, 3, adim)
    col = ((wab * invzb)[..., None] * attr).sum(2) \
        / torch.clamp_min(invz_pix, 1e-12)[..., None]
    return _pack_tiles(col, best_z, hit, rows[..., -1].long())


def _empty_tiles(T: int, P: int, dtype, device) -> torch.Tensor:
    out = torch.zeros((T, 8, P), dtype=dtype, device=device)
    out[:, 3] = math.inf     # depth
    out[:, 5] = -1.0         # face id
    return out


@span("mesh.raster")
def rasterize_mesh(
    vertices: torch.Tensor,        # (V, 3) world space
    faces: torch.Tensor,           # (F, 3) int
    camera: Camera,
    vertex_colors: Optional[torch.Tensor] = None,   # (V, 3)
    face_colors: Optional[torch.Tensor] = None,     # (F, 3)
    cfg: MeshRasterConfig = MeshRasterConfig(),
    face_valid: Optional[torch.Tensor] = None,      # (F,) bool
    vertex_uvs: Optional[torch.Tensor] = None,      # (V, 2) texcoords
    texture: Optional[torch.Tensor] = None,         # (Th, Tw, 3) in [0,1]
) -> Dict[str, torch.Tensor]:
    """Rasterize on the device of `vertices` (the camera is moved there).

    Returns rgb (H,W,3), depth (H,W; +inf empty), mask (H,W) bool,
    face_id (H,W) int64 (-1 empty), stats (BinStats of the triangle
    binning: truncated triangles, overflowed tiles), near_clipped and
    near_dropped (0-d counts of faces straddling the near plane, clipped
    or, with clip_near off, dropped).

    With vertex_uvs + texture, UVs ride the two spare attribute rows
    (perspective-correct like colors) and the texture is sampled
    bilinearly once over the image afterwards; rgb = interpolated color
    x texture (glTF base-color modulation; the color term defaults to 1
    when only a texture is given)."""
    W, H = camera.width, camera.height
    ts = cfg.tile_size
    tiles_x, tiles_y = num_tiles(W, H, ts)
    T, P = tiles_x * tiles_y, ts * ts
    dev = vertices.device
    camera = camera.to(dev)
    faces = faces.long()

    w2c = camera.w2c
    tri_cam = (vertices @ w2c[:3, :3].T + w2c[:3, 3])[faces]   # (F, 3, 3)
    textured = vertex_uvs is not None and texture is not None
    if face_colors is None:
        if vertex_colors is None:
            # white base color under a texture (pure texture look); light
            # gray otherwise
            vertex_colors = torch.full_like(vertices, 1.0 if textured else 0.7)
        tri_col = vertex_colors[faces]                         # (F, 3, 3)
    else:
        tri_col = face_colors[:, None, :].expand(-1, 3, -1)
    if textured:
        tri_col = torch.cat([tri_col, vertex_uvs[faces]], dim=-1)
    else:
        tri_col = torch.cat([tri_col, tri_col.new_zeros(tri_col.shape[:2] + (2,))],
                            dim=-1)                            # (F, 3, 5)

    front = tri_cam[:, :, 2] > cfg.near
    n_near = (front.any(1) & ~front.all(1)).sum()
    src_valid = (torch.ones((faces.shape[0],), dtype=torch.bool, device=dev)
                 if face_valid is None else face_valid)
    if cfg.clip_near:
        tri_cam, tri_col, clip_valid, fid_src = _clip_near_plane(
            tri_cam, tri_col, cfg.near)
        face_ok = clip_valid & src_valid[fid_src]
    else:
        face_ok = front.all(1) & src_valid
        fid_src = torch.arange(faces.shape[0], device=dev)

    z = tri_cam[:, :, 2]
    z_ok = z > 0.5 * cfg.near
    z_safe = torch.where(z_ok, z, torch.ones_like(z))
    tri_uv = torch.stack([
        camera.fx * tri_cam[:, :, 0] / z_safe + camera.cx - 0.5,
        camera.fy * tri_cam[:, :, 1] / z_safe + camera.cy - 0.5,
    ], dim=-1)                                                 # (F', 3, 2)
    tri_invz = torch.where(z_ok, 1.0 / z_safe, torch.zeros_like(z))

    # signed twice-area in screen space; degenerate triangles dropped
    e1 = tri_uv[:, 1] - tri_uv[:, 0]
    e2 = tri_uv[:, 2] - tri_uv[:, 0]
    area = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    valid = face_ok & z_ok.all(1) & (area.abs() > 1e-12)

    # tile bbox
    uvd = tri_uv.detach()
    minu, maxu = uvd[:, :, 0].amin(1), uvd[:, :, 0].amax(1)
    minv, maxv = uvd[:, :, 1].amin(1), uvd[:, :, 1].amax(1)
    valid = valid & (maxu >= 0) & (minu <= W - 1) & (maxv >= 0) & (minv <= H - 1)

    def edge(x, hi):
        return torch.clamp(torch.floor(x / ts), 0, hi - 1).long()

    tx0, tx1 = edge(minu, tiles_x), edge(maxu, tiles_x)
    ty0, ty1 = edge(minv, tiles_y), edge(maxv, tiles_y)
    tx1 = torch.where(valid, tx1, tx0 - 1)                     # empty bbox
    rank = torch.arange(tri_uv.shape[0], device=dev)   # z-buffer: any order
    with span("mesh.bin"):
        sel, counts, stats = bin_rects(tx0, ty0, tx1, ty1, rank, valid,
                                       tiles_x, tiles_y,
                                       cfg.max_tiles_per_tri,
                                       cfg.tile_capacity)
    count("mesh.truncated", stats.truncated_gaussians)
    count("mesh.overflowed_tiles", stats.overflowed_tiles)

    # the non-empty tiles, in groups bounded by _GROUP_ELEMS (one sync)
    with span("mesh.read_counts"):
        counts_host = counts.cpu()
    busy = torch.nonzero(counts_host > 0)[:, 0]
    tiles = _empty_tiles(T, P, tri_uv.dtype, dev)
    if busy.numel():
        Kc = int(counts_host[busy].max())
        per_tile = P * (min(cfg.tri_chunk, Kc) if cfg.tri_chunk > 0 else Kc)
        group = max(1, _GROUP_ELEMS.get(dev.type, _GROUP_ELEMS["cpu"])
                    // per_tile)
        busy = busy.to(dev)
        parts = []
        for g0 in range(0, busy.numel(), group):
            t_idx = busy[g0:g0 + group]
            args = (sel[t_idx, :Kc], counts[t_idx].long(), t_idx, tri_uv,
                    tri_invz, tri_col, area, fid_src, tiles_x, ts)
            parts.append(_tiles_chunked(*args, cfg.tri_chunk)
                         if cfg.tri_chunk > 0 else _tiles_unchunked(*args))
        tiles = tiles.index_put((busy,), torch.cat(parts))
    img = untile(tiles, tiles_x, tiles_y, W, H, ts)            # (H, W, 8)
    mask = img[..., 4] > 0.5
    depth = torch.where(mask, img[..., 3], torch.full_like(img[..., 3], math.inf))
    rgb = img[..., :3]
    if textured:
        rgb = rgb * _sample_texture_image(texture, img[..., 6], img[..., 7])
    zero = torch.zeros_like(n_near)
    return {
        "rgb": rgb,
        "depth": depth,
        "mask": mask,
        "face_id": torch.where(mask, img[..., 5].long(),
                               torch.full_like(mask, -1, dtype=torch.long)),
        "stats": stats,
        # with clip_near these are CLIPPED (kept), not dropped
        "near_dropped": zero if cfg.clip_near else n_near,
        "near_clipped": n_near if cfg.clip_near else zero,
    }
