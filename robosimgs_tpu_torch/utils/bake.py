"""View->mesh appearance baking and midpoint subdivision.

A port of robosimgs_tpu/utils/bake.py. Recovers per-vertex appearance
for a scanned mesh from posed RGB views (the upstream RoboSimGS workflow
captures appearance as a photogrammetry texture; its released artifacts
ship TEXTURELESS part meshes + six posed renders of the textured scan).
Baking back-projects those views onto the mesh with z-buffer visibility
tests, which is what lets the framework synthesize DENSE captures of
the real object for reconstruction training.

Only `_collect_view_samples` touches the device: one
render/mesh_raster.py z-buffer per view, on the cameras' device (a
truncated z-buffer raises). The rest is numpy, as in the JAX package:
one (V,)-row projection per view, and a chunked distance argmin for
filling vertices no view sees.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

import torch

from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.render.mesh_raster import (MeshRasterConfig,
                                                    rasterize_mesh)
from robosimgs_tpu_torch.utils.meshio import Mesh


def subdivide_mesh(mesh: Mesh, iterations: int = 1) -> Mesh:
    """Midpoint (1:4) subdivision without smoothing: each triangle
    splits into four via deduplicated edge midpoints. Vertex colors and
    UVs are averaged onto the midpoints; the shared texture is carried.
    Geometry is unchanged — this only adds resolution for per-vertex
    baking."""
    v = mesh.vertices
    f = mesh.faces
    vc = mesh.vertex_colors
    uv = mesh.uv
    for _ in range(iterations):
        edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        edges_sorted = np.sort(edges, axis=1)
        uniq, inverse = np.unique(edges_sorted, axis=0, return_inverse=True)
        mid = 0.5 * (v[uniq[:, 0]] + v[uniq[:, 1]])
        base = v.shape[0]
        mid_idx = (base + inverse).reshape(3, -1).T      # (F, 3): m01 m12 m20
        v = np.concatenate([v, mid]).astype(np.float32)
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        m01, m12, m20 = mid_idx[:, 0], mid_idx[:, 1], mid_idx[:, 2]
        f = np.concatenate([
            np.stack([a, m01, m20], 1),
            np.stack([m01, b, m12], 1),
            np.stack([m20, m12, c], 1),
            np.stack([m01, m12, m20], 1),
        ]).astype(np.int32)
        if vc is not None:
            vc = np.concatenate(
                [vc, 0.5 * (vc[uniq[:, 0]] + vc[uniq[:, 1]])]).astype(np.float32)
        if uv is not None:
            uv = np.concatenate(
                [uv, 0.5 * (uv[uniq[:, 0]] + uv[uniq[:, 1]])]).astype(np.float32)
    return Mesh(vertices=v, faces=f, vertex_colors=vc, uv=uv,
                texture=mesh.texture)


def vertex_normals(mesh: Mesh) -> np.ndarray:
    """Area-weighted vertex normals (V, 3)."""
    v, f = mesh.vertices, mesh.faces
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    vn = np.zeros_like(v)
    for k in range(3):
        np.add.at(vn, f[:, k], fn)
    n = np.linalg.norm(vn, axis=1, keepdims=True)
    return (vn / np.clip(n, 1e-12, None)).astype(np.float32)


def _masked_bilinear(img: np.ndarray, valid: np.ndarray, u: np.ndarray,
                     v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Bilinear image sample where each tap is weighted by its validity
    (object coverage): silhouette samples don't bleed background into
    the bake. Returns (colors (N, C), coverage (N,) = valid tap weight
    in [0, 1])."""
    H, W = img.shape[:2]
    x = np.clip(u, 0.0, W - 1.0)
    y = np.clip(v, 0.0, H - 1.0)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    fx = x - x0
    fy = y - y0
    acc = np.zeros((x.shape[0], img.shape[2]), np.float64)
    wacc = np.zeros((x.shape[0],), np.float64)
    for (yi, xi, w) in ((y0, x0, (1 - fx) * (1 - fy)),
                        (y0, x1, fx * (1 - fy)),
                        (y1, x0, (1 - fx) * fy),
                        (y1, x1, fx * fy)):
        wv = w * valid[yi, xi]
        acc += wv[:, None] * img[yi, xi]
        wacc += wv
    cols = acc / np.clip(wacc[:, None], 1e-12, None)
    return cols.astype(np.float32), wacc.astype(np.float32)


def _collect_view_samples(
    mesh: Mesh,
    images: Sequence[np.ndarray],
    cameras: Sequence[Camera],
    depth_tol: float,
    min_cos: float,
    tile_capacity: int,
    max_tiles_per_tri: int,
    tri_chunk: int,
    pet=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-view back-projection samples for every vertex.

    Returns (cols (n, V, 3), wts (n, V), dirs (n, V, 3)) float32: the
    bilinear image color each view observes at each vertex, its
    visibility/angle/coverage weight (0 = not visible from that view),
    and the unit vertex->camera direction. One mesh-raster z-buffer per
    view, on each camera's device; capacity overflows raise (a
    truncated z-buffer silently corrupts visibility)."""
    v = mesh.vertices
    normals = vertex_normals(mesh)
    cfg = MeshRasterConfig(tile_capacity=tile_capacity,
                           max_tiles_per_tri=max_tiles_per_tri,
                           tri_chunk=tri_chunk)
    all_cols, all_w, all_dirs = [], [], []
    for img, cam in zip(images, cameras):
        dev = cam.c2w.device
        with torch.no_grad():     # the z-buffer: colours do not matter
            out = rasterize_mesh(torch.as_tensor(v, device=dev),
                                 torch.as_tensor(mesh.faces, device=dev),
                                 cam, cfg=cfg)
        st = out["stats"]
        if int(st.truncated_gaussians) or int(st.overflowed_tiles):
            raise ValueError(
                f"bake raster truncation (tris={int(st.truncated_gaussians)}"
                f", tiles={int(st.overflowed_tiles)}, max_tile_count="
                f"{int(st.max_tile_count)}): raise capacities")
        if pet is not None:
            pet()
        zbuf = out["depth"].cpu().numpy()       # (H, W), +inf empty
        host = cam.to("cpu")
        w2c = host.w2c.numpy()
        pc = v @ w2c[:3, :3].T + w2c[:3, 3]
        z = pc[:, 2]
        fx, fy = float(host.fx), float(host.fy)
        cx, cy = float(host.cx), float(host.cy)
        zs = np.where(z > 1e-6, z, 1.0)
        u = fx * pc[:, 0] / zs + cx - 0.5
        uu = fy * pc[:, 1] / zs + cy - 0.5
        H, W = zbuf.shape
        inb = (z > 1e-6) & (u >= 0) & (u <= W - 1) & (uu >= 0) & (uu <= H - 1)
        cover = np.isfinite(zbuf).astype(np.float64)
        znear, zcov = _masked_bilinear(
            np.where(np.isfinite(zbuf), zbuf, 0.0)[..., None], cover, u, uu)
        visible = inb & (zcov > 0.5) & (z <= znear[:, 0]
                                        * (1.0 + depth_tol) + 1e-4)
        eye = host.origin.numpy()
        to_cam = eye[None, :] - v
        to_cam /= np.clip(np.linalg.norm(to_cam, axis=1, keepdims=True),
                          1e-12, None)
        cosw = np.abs((normals * to_cam).sum(1))
        col, ccov = _masked_bilinear(np.asarray(img, np.float32), cover,
                                     u, uu)
        # weight by view angle AND object coverage of the bilinear
        # footprint, so silhouette-straddling samples count less
        w = np.where(visible & (cosw > min_cos), cosw * ccov, 0.0)
        all_cols.append(col.astype(np.float32))
        all_w.append(w.astype(np.float32))
        all_dirs.append(to_cam.astype(np.float32))
    return (np.stack(all_cols), np.stack(all_w), np.stack(all_dirs))


def bake_vertex_colors_from_views(
    mesh: Mesh,
    images: Sequence[np.ndarray],            # (H, W, 3) float32 in [0,1]
    cameras: Sequence[Camera],
    depth_tol: float = 0.01,                 # relative z-buffer slack
    min_cos: float = 0.15,                   # grazing-angle cutoff
    tile_capacity: int = 1024,
    max_tiles_per_tri: int = 512,
    tri_chunk: int = 0,                      # chunked z-buffer (big K)
    pet=None,                                # watchdog callback per view
) -> Tuple[np.ndarray, np.ndarray]:
    """Back-project posed views onto mesh vertices.

    Visibility is a per-view mesh-raster z-buffer test (vertex depth
    within depth_tol of the rasterized surface), weighting is
    cos(normal, to-camera) above the grazing cutoff. Vertices no view
    passes are filled from their nearest seen vertex. Returns
    (colors (V, 3) float32, seen (V,) bool)."""
    cols, wts, _ = _collect_view_samples(
        mesh, images, cameras, depth_tol, min_cos, tile_capacity,
        max_tiles_per_tri, tri_chunk, pet)
    acc = np.einsum("nv,nvc->vc", wts.astype(np.float64),
                    cols.astype(np.float64))
    wsum = wts.astype(np.float64).sum(0)
    seen = wsum > 0
    colors = np.where(seen[:, None], acc / np.clip(wsum[:, None], 1e-12, None),
                      0.5).astype(np.float32)
    v = mesh.vertices
    if seen.any() and not seen.all():
        colors[~seen] = colors[seen][_nearest_indices(v[~seen], v[seen])]
    return colors, seen


@dataclass
class BakedAppearance:
    """View-dependent per-vertex appearance recovered by the bake.

    color(vertex, view dir d) = sh0 + dir1 @ [dx, dy, dz] — sh0 is the
    diffuse (degree-0) term, dir1 a per-vertex linear directional term
    (the same function space as real SH degree 1, in the monomial
    basis). view_gain/view_bias are the per-view affine exposures the
    solve removed from the observations (identity when exposure
    solving is off)."""

    sh0: np.ndarray        # (V, 3) float32
    dir1: np.ndarray       # (V, 3, 3) float32: [vertex, dir-xyz, channel]
    seen: np.ndarray       # (V,) bool
    view_gain: np.ndarray  # (n_views, 3) float32
    view_bias: np.ndarray  # (n_views, 3) float32


def _solve_view_exposure(cols: np.ndarray, wts: np.ndarray,
                         iters: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """Per-view per-channel affine exposure (gain, bias) aligning every
    view's observations to the cross-view consensus.

    Alternates (a) per-vertex weighted mean of corrected colors and
    (b) per-view 2x2 weighted least squares of (gain*obs + bias - mean).
    The global affine gauge freedom is pinned by renormalizing the
    weight-averaged correction to identity each sweep, so the solve
    removes view-to-view DISAGREEMENT without drifting overall
    brightness. Degenerate views (no samples / flat color) stay
    identity; gains are clamped to [0.2, 5]."""
    n = cols.shape[0]
    g = np.ones((n, 3), np.float64)
    b = np.zeros((n, 3), np.float64)
    c = cols.astype(np.float64)
    w = wts.astype(np.float64)
    multi = (w > 0).sum(0) >= 2      # only multi-view vertices constrain
    w = w * multi[None, :]
    if w.sum() <= 1e-8:              # no cross-view overlap: nothing to
        return (g.astype(np.float32),  # align, solve stays identity
                b.astype(np.float32))
    for _ in range(iters):
        corr = g[:, None, :] * c + b[:, None, :]
        mu = np.einsum("nv,nvc->vc", w, corr) / np.clip(
            w.sum(0)[:, None], 1e-12, None)
        # per view/channel WLS: minimize sum_v w (g*c + b - mu)^2
        sw = w.sum(1)                                    # (n,)
        sc = np.einsum("nv,nvc->nc", w, c)
        scc = np.einsum("nv,nvc->nc", w, c * c)
        sm = np.einsum("nv,vc->nc", w, mu)
        scm = np.einsum("nv,nvc,vc->nc", w, c, mu)
        det = sw[:, None] * scc - sc * sc
        ok = (sw[:, None] > 1e-8) & (det > 1e-10 * np.maximum(scc, 1e-12))
        g_new = np.where(ok, (sw[:, None] * scm - sc * sm)
                         / np.where(ok, det, 1.0), 1.0)
        g_new = np.clip(g_new, 0.2, 5.0)
        b_new = np.where(ok, (sm - g_new * sc)
                         / np.clip(sw[:, None], 1e-8, None), 0.0)
        # pin the gauge: weight-averaged correction -> identity
        vw = sw / np.clip(sw.sum(), 1e-12, None)
        gbar = (vw[:, None] * g_new).sum(0)
        bbar = (vw[:, None] * b_new).sum(0)
        # re-apply the clamp post-gauge so the documented [0.2, 5] bound
        # holds on the RETURNED gains, not just pre-normalization
        g = np.clip(g_new / np.clip(gbar[None, :], 1e-6, None), 0.2, 5.0)
        b = (b_new - bbar[None, :]) / np.clip(gbar[None, :], 1e-6, None)
    return g.astype(np.float32), b.astype(np.float32)


def bake_appearance_from_views(
    mesh: Mesh,
    images: Sequence[np.ndarray],
    cameras: Sequence[Camera],
    depth_tol: float = 0.01,
    min_cos: float = 0.15,
    tile_capacity: int = 1024,
    max_tiles_per_tri: int = 512,
    tri_chunk: int = 0,
    pet=None,
    exposure: bool = True,
    degree: int = 1,                         # 0 = diffuse only
    dir_reg: float = 0.5,                    # Tikhonov on dir1, rel. wsum
) -> BakedAppearance:
    """View-dependent bake: exposure-aligned back-projection plus a
    per-vertex degree-1 directional color model.

    The plain bake (`bake_vertex_colors_from_views`) averages whatever
    shading each view saw into one diffuse color; disagreeing exposures
    and specular lobes both land as blur. This solver first removes a
    per-view affine exposure (gain/bias per channel), then fits
    color(d) = sh0 + dir1 @ d per vertex by ridge-regularized weighted
    least squares over the observed vertex->camera directions d. With
    few or degenerate observations the ridge term shrinks dir1 to 0 and
    the fit falls back to the diffuse mean. Unseen vertices copy their
    nearest seen vertex's sh0 (dir1 = 0)."""
    cols, wts, dirs = _collect_view_samples(
        mesh, images, cameras, depth_tol, min_cos, tile_capacity,
        max_tiles_per_tri, tri_chunk, pet)
    n, V = wts.shape
    if exposure and n >= 2:
        gain, bias = _solve_view_exposure(cols, wts)
    else:
        gain = np.ones((n, 3), np.float32)
        bias = np.zeros((n, 3), np.float32)
    c = gain[:, None, :] * cols.astype(np.float64) + bias[:, None, :]
    w = wts.astype(np.float64)
    wsum = w.sum(0)
    seen = wsum > 0
    mu = np.einsum("nv,nvc->vc", w, c) / np.clip(wsum[:, None], 1e-12, None)

    dir1 = np.zeros((V, 3, 3), np.float32)
    if degree >= 1 and n >= 2:
        # per-vertex ridge WLS in the centered basis: residual(d) =
        # dir1 @ d with A = sum_n w d d^T + lam I (3x3 batched solve).
        # Centering the colors on mu keeps sh0 = exposure-corrected mean
        # exactly, so degree=1 strictly refines the diffuse bake.
        d = dirs.astype(np.float64)                      # (n, V, 3)
        res = c - mu[None, :, :]                         # (n, V, 3)
        A = np.einsum("nv,nvi,nvj->vij", w, d, d)        # (V, 3, 3)
        rhs = np.einsum("nv,nvi,nvc->vic", w, d, res)    # (V, 3, 3)
        lam = dir_reg * np.clip(wsum, 1e-12, None)
        A = A + lam[:, None, None] * np.eye(3)[None]
        dir1 = np.linalg.solve(A, rhs).astype(np.float32)
        dir1[~seen] = 0.0

    v = mesh.vertices
    # the exposure-corrected mean can leave [0, 1]; sh0 is assigned to
    # vertex_colors downstream (Gaussians.from_points init), so clip here
    sh0 = np.clip(np.where(seen[:, None], mu, 0.5), 0.0, 1.0).astype(
        np.float32)
    if seen.any() and not seen.all():
        sh0[~seen] = sh0[seen][_nearest_indices(v[~seen], v[seen])]
    return BakedAppearance(sh0=sh0, dir1=dir1, seen=seen,
                           view_gain=gain, view_bias=bias)


def eval_baked_colors(baked: BakedAppearance, vertices: np.ndarray,
                      cam_origin: np.ndarray) -> np.ndarray:
    """Per-vertex colors for a novel viewpoint: sh0 + dir1 @ d with d
    the unit vertex->camera direction, clipped to [0, 1]."""
    d = np.asarray(cam_origin, np.float32)[None, :] - vertices
    d = d / np.clip(np.linalg.norm(d, axis=1, keepdims=True), 1e-12, None)
    cols = baked.sh0 + np.einsum("vic,vi->vc", baked.dir1, d)
    return np.clip(cols, 0.0, 1.0).astype(np.float32)


def _nearest_indices(query: np.ndarray, ref: np.ndarray,
                     chunk: int = 4096) -> np.ndarray:
    """argmin_j |query_i - ref_j| in chunks (bounds the (Q, R) matrix)."""
    out = np.empty(query.shape[0], np.int64)
    r2 = (ref ** 2).sum(1)
    for s in range(0, query.shape[0], chunk):
        q = query[s:s + chunk]
        d = (q ** 2).sum(1)[:, None] - 2.0 * q @ ref.T + r2[None, :]
        out[s:s + chunk] = d.argmin(1)
    return out
