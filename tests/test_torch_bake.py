"""The port's utils/bake.py against the JAX package on the CPU: the cases
of tests/test_bake.py, each also holding the port's output against the
JAX function's on the same images and cameras. The views are rendered
once by the port's mesh rasterizer and fed to both bakes; each bake
rasterizes its own z-buffers. Bake colours, weights and directions
within 1e-4; subdivision, normals and the exposure solve (numpy in both)
equal to 1e-6.
"""

import jax.numpy as jnp  # noqa: F401  (tests import both packages)
import numpy as np
import pytest
import torch

from robosimgs_tpu.core.camera import Camera as JCamera
from robosimgs_tpu.utils import bake as jbake
from robosimgs_tpu.utils.meshio import Mesh as JMesh
from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.render.mesh_raster import (MeshRasterConfig,
                                                    rasterize_mesh)
from robosimgs_tpu_torch.utils import bake
from robosimgs_tpu_torch.utils.meshio import Mesh

ATOL = 1e-4


def _cube(size=1.0):
    s = size / 2.0
    v = np.array([[-s, -s, -s], [s, -s, -s], [s, s, -s], [-s, s, -s],
                  [-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s]], np.float32)
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
                  [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
                  [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]], np.int32)
    return Mesh(vertices=v, faces=f)


def _jmesh(m: Mesh) -> JMesh:
    return JMesh(vertices=m.vertices, faces=m.faces,
                 vertex_colors=m.vertex_colors, uv=m.uv, texture=m.texture)


_VIEW_DIRS = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
              [0.3, 0.2, 1], [0.3, 0.2, -1]]


def _look(d, size=160):
    d = np.asarray(d, np.float64)
    eye = d / np.linalg.norm(d) * 3.0
    up = [0, 0, 1] if abs(d[2]) < 0.9 else [0, 1, 0]
    return eye, [0, 0, 0], up, 45.0, size, size


def _render_views(m, per_view_colors, dirs=None):
    """Rasterize the mesh once per view direction with the port; returns
    (port cameras, JAX cameras, images). per_view_colors maps view index
    -> (V, 3) vertex colors (view-dependent appearance is emulated by
    re-coloring per view)."""
    cams, jcams, imgs = [], [], []
    cfg = MeshRasterConfig(tile_capacity=1024, max_tiles_per_tri=512)
    for i, d in enumerate(dirs if dirs is not None else _VIEW_DIRS):
        args = _look(d)
        cam = Camera.look_at(*args, device="cpu")
        out = rasterize_mesh(
            torch.as_tensor(m.vertices), torch.as_tensor(m.faces), cam,
            vertex_colors=torch.as_tensor(per_view_colors(i, cam)), cfg=cfg)
        img = np.where(out["mask"].numpy()[..., None], out["rgb"].numpy(),
                       0.0).astype(np.float32)
        cams.append(cam)
        jcams.append(JCamera.look_at(*args))
        imgs.append(img)
    return cams, jcams, imgs


def test_subdivide_counts_and_surface():
    m = _cube()
    m.vertex_colors = np.random.default_rng(0).uniform(
        size=(8, 3)).astype(np.float32)
    s = bake.subdivide_mesh(m, 2)
    js = jbake.subdivide_mesh(_jmesh(m), 2)
    for name in ("vertices", "faces", "vertex_colors"):
        np.testing.assert_array_equal(getattr(s, name), getattr(js, name))
    assert s.faces.shape[0] == 12 * 16
    # midpoint subdivision leaves every new vertex ON the original
    # surface: for the cube, max |coord| stays 0.5
    assert np.isclose(np.abs(s.vertices).max(), 0.5, atol=1e-6)
    # edge midpoints are deduplicated: V = 8 + unique edges each round
    assert s.vertices.shape[0] < 12 * 16 * 3
    assert s.vertex_colors.shape == (s.vertices.shape[0], 3)
    np.testing.assert_allclose(s.face_areas().sum(), m.face_areas().sum(),
                               rtol=1e-5)


def test_vertex_normals_cube_corners():
    n = bake.vertex_normals(_cube())
    np.testing.assert_allclose(n, jbake.vertex_normals(_jmesh(_cube())),
                               atol=1e-6)
    # each cube corner normal points outward (same octant as the vertex)
    assert (np.sign(n) == np.sign(_cube().vertices)).mean() > 0.9


def test_bake_recovers_vertex_colors():
    """Render a colored cube from 6 views (unshaded), strip the colors,
    bake them back from the images: visible vertices recover their
    color, as the JAX bake does."""
    m = bake.subdivide_mesh(_cube(), 1)
    # smooth-ish colors (bilinear image sampling blends at silhouettes)
    m.vertex_colors = (0.25 + 0.5 * (m.vertices + 0.5)).astype(np.float32)
    cams, jcams, imgs = _render_views(m, lambda i, cam: m.vertex_colors)

    colors, seen = bake.bake_vertex_colors_from_views(m, imgs, cams)
    jcolors, jseen = jbake.bake_vertex_colors_from_views(_jmesh(m), imgs,
                                                         jcams)
    np.testing.assert_array_equal(seen, jseen)
    np.testing.assert_allclose(colors, jcolors, atol=ATOL)
    assert seen.mean() > 0.9           # nearly every cube vertex is seen
    err = np.abs(colors[seen] - m.vertex_colors[seen])
    # silhouette-edge vertices can blend with the background, so judge
    # the bulk, not the max
    assert np.median(err) < 0.02, float(np.median(err))
    assert np.percentile(err, 90) < 0.1, float(np.percentile(err, 90))


def _exposure_case():
    m = bake.subdivide_mesh(_cube(), 1)
    # non-axis-aligned smooth field: every channel varies on every cube
    # face, so each view constrains all three per-channel gains
    x, y, z = m.vertices.T
    truth = np.stack([0.3 + 0.2 * (x + y + 1.0),
                      0.3 + 0.2 * (y + z + 1.0),
                      0.3 + 0.2 * (z - x + 1.0)], 1).astype(np.float32)
    rng = np.random.default_rng(3)
    gains = (1.0 + rng.uniform(-0.2, 0.2, size=(6, 3))).astype(np.float32)
    biases = rng.uniform(-0.05, 0.05, size=(6, 3)).astype(np.float32)
    cams, jcams, imgs = _render_views(m, lambda i, cam: truth)
    imgs = [g * im + b for im, g, b in          # no clipping (range < 0.9)
            zip(imgs, gains[:, None, None, :], biases[:, None, None, :])]
    return m, truth, cams, jcams, imgs


def _assert_baked_equal(b, jb):
    np.testing.assert_array_equal(b.seen, jb.seen)
    for name in ("sh0", "dir1", "view_gain", "view_bias"):
        np.testing.assert_allclose(getattr(b, name), getattr(jb, name),
                                   atol=ATOL, err_msg=name)


def test_bake_exposure_solve_removes_view_disagreement():
    """Each view corrupted by a different affine exposure: the solve
    recovers per-view gains (up to the pinned global gauge) and the
    exposure-corrected bake lands closer to truth than the plain one."""
    m, truth, cams, jcams, imgs = _exposure_case()
    plain, seen = bake.bake_vertex_colors_from_views(m, imgs, cams)
    baked = bake.bake_appearance_from_views(m, imgs, cams, degree=0)
    _assert_baked_equal(baked, jbake.bake_appearance_from_views(
        _jmesh(m), imgs, jcams, degree=0))

    def gauge_err(est):
        """Residual after the best single global affine per channel."""
        e, t = est[seen].astype(np.float64), truth[seen].astype(np.float64)
        resid = np.empty_like(e)
        for c in range(3):
            a, b = np.polyfit(e[:, c], t[:, c], 1)
            resid[:, c] = a * e[:, c] + b - t[:, c]
        return np.median(np.abs(resid))

    err_plain = gauge_err(plain)
    err_solved = gauge_err(baked.sh0)
    assert err_solved < 0.5 * err_plain, (err_solved, err_plain)
    assert err_solved < 0.01, err_solved
    # the solve's objective: per-vertex cross-view disagreement of the
    # CORRECTED observations collapses against the raw ones
    cols, wts, dirs = bake._collect_view_samples(m, imgs, cams, 0.01, 0.15,
                                                 1024, 512, 0)
    w = wts * ((wts > 0).sum(0) >= 2)[None, :]

    def disagreement(c):
        mu = np.einsum("nv,nvc->vc", w, c) / np.clip(
            w.sum(0)[:, None], 1e-12, None)
        var = np.einsum("nv,nvc->vc", w, (c - mu[None]) ** 2) / np.clip(
            w.sum(0)[:, None], 1e-12, None)
        return float(np.median(var[w.sum(0) > 0]))

    raw = disagreement(cols)
    corrected = disagreement(
        baked.view_gain[:, None, :] * cols + baked.view_bias[:, None, :])
    assert corrected < 0.25 * raw, (corrected, raw)


def test_collect_view_samples_matches_jax():
    m, _, cams, jcams, imgs = _exposure_case()
    got = bake._collect_view_samples(m, imgs, cams, 0.01, 0.15, 1024, 512, 0)
    want = jbake._collect_view_samples(_jmesh(m), imgs, jcams, 0.01, 0.15,
                                       1024, 512, 0)
    for g, w, name in zip(got, want, ("cols", "wts", "dirs")):
        np.testing.assert_allclose(g, w, atol=ATOL, err_msg=name)
    assert ((got[1] > 0) == (want[1] > 0)).all()


def test_bake_degree1_recovers_view_dependence():
    """Ground-truth appearance with a linear directional term (the
    degree-1 function space): the directional bake predicts a NOVEL
    view's vertex colors better than the diffuse bake."""
    m = bake.subdivide_mesh(_cube(), 2)
    rng = np.random.default_rng(5)
    base = (0.35 + 0.3 * (m.vertices + 0.5)).astype(np.float32)
    D = rng.uniform(-0.1, 0.1, size=(m.vertices.shape[0], 3, 3)).astype(
        np.float32)                      # [vertex, dir, channel]

    def colors_for(i, cam):
        d = cam.origin.numpy()[None, :] - m.vertices
        d /= np.clip(np.linalg.norm(d, axis=1, keepdims=True), 1e-12, None)
        return np.clip(base + np.einsum("vic,vi->vc", D, d), 0, 1)

    # axis views + diagonals: enough directional span that face-interior
    # vertices collect >= 3 observed directions for the 3-parameter fit
    view_dirs = _VIEW_DIRS + [[1, 1, 0.6], [-1, 1, 0.6], [1, -1, 0.6],
                              [-1, -1, 0.6]]
    cams, jcams, imgs = _render_views(m, colors_for, dirs=view_dirs)
    b0 = bake.bake_appearance_from_views(m, imgs, cams, exposure=False,
                                         degree=0)
    b1 = bake.bake_appearance_from_views(m, imgs, cams, exposure=False,
                                         degree=1, dir_reg=0.1)
    _assert_baked_equal(b1, jbake.bake_appearance_from_views(
        _jmesh(m), imgs, jcams, exposure=False, degree=1, dir_reg=0.1))
    _, wts, _ = bake._collect_view_samples(m, imgs, cams, 0.01, 0.15, 1024,
                                           512, 0)
    well = (wts > 0).sum(0) >= 3         # fit is determined here
    assert well.mean() > 0.3, well.mean()
    novel_eye = np.asarray([1.0, 0.6, 1.0])
    novel_eye = novel_eye / np.linalg.norm(novel_eye) * 3.0
    d = novel_eye[None, :] - m.vertices
    d /= np.clip(np.linalg.norm(d, axis=1, keepdims=True), 1e-12, None)
    truth = np.clip(base + np.einsum("vic,vi->vc", D, d), 0, 1)
    e0 = np.median(np.abs(bake.eval_baked_colors(b0, m.vertices, novel_eye)
                          [well] - truth[well]))
    e1 = np.median(np.abs(bake.eval_baked_colors(b1, m.vertices, novel_eye)
                          [well] - truth[well]))
    np.testing.assert_allclose(
        bake.eval_baked_colors(b1, m.vertices, novel_eye),
        jbake.eval_baked_colors(b1, m.vertices, novel_eye), atol=1e-6)
    assert e1 < 0.7 * e0, (e1, e0)
    assert e1 < 0.03, e1


def test_bake_appearance_single_view_identity_exposure():
    m = bake.subdivide_mesh(_cube(), 1)
    truth = (0.25 + 0.5 * (m.vertices + 0.5)).astype(np.float32)
    cams, jcams, imgs = _render_views(m, lambda i, cam: truth,
                                      dirs=_VIEW_DIRS[:1])
    baked = bake.bake_appearance_from_views(m, imgs, cams)
    _assert_baked_equal(baked, jbake.bake_appearance_from_views(
        _jmesh(m), imgs, jcams))
    np.testing.assert_array_equal(baked.view_gain, 1.0)
    np.testing.assert_array_equal(baked.view_bias, 0.0)
    np.testing.assert_array_equal(baked.dir1, 0.0)  # needs >= 2 views
    # degenerate single view still produces a usable diffuse bake
    assert baked.seen.any()


def test_exposure_solve_identity_without_overlap():
    """Disjoint visibility (no vertex seen by >= 2 views) gives the solve
    nothing to align: it returns identity, as the JAX package's does."""
    rng = np.random.default_rng(7)
    cols = rng.uniform(0.2, 0.8, size=(2, 40, 3)).astype(np.float32)
    wts = np.zeros((2, 40), np.float32)
    wts[0, :20] = 1.0
    wts[1, 20:] = 1.0
    g, b = bake._solve_view_exposure(cols, wts)
    jg, jb = jbake._solve_view_exposure(cols, wts)
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(g, 1.0)
    np.testing.assert_array_equal(b, 0.0)


def test_bake_raises_on_truncation():
    m = _cube()
    args = ([2.5, 0.4, 0.6], [0, 0, 0], [0, 0, 1], 45.0, 512, 512)
    img = np.zeros((512, 512, 3), np.float32)
    with pytest.raises(ValueError, match="bake raster truncation"):
        bake.bake_vertex_colors_from_views(
            m, [img], [Camera.look_at(*args, device="cpu")],
            max_tiles_per_tri=4)
    with pytest.raises(ValueError, match="bake raster truncation"):
        jbake.bake_vertex_colors_from_views(_jmesh(m), [img],
                                            [JCamera.look_at(*args)],
                                            max_tiles_per_tri=4)
