"""Mesh rasterizer and depth-merged compositing parity: the port's
bin_rects, per_gaussian_cover, rasterize_mesh and render_composite on CPU
tensors against the JAX package's on the same numpy inputs (its tiled
compositor runs the Pallas kernel in interpret mode)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosimgs_tpu.core.camera import Camera as JCamera
from robosimgs_tpu.core.types import Gaussians as JGaussians
from robosimgs_tpu.render import binning as jbinning
from robosimgs_tpu.render.compose import render_composite as jcomposite
from robosimgs_tpu.render.config import RenderConfig as JConfig
from robosimgs_tpu.render.mesh_raster import MeshRasterConfig as JMeshConfig
from robosimgs_tpu.render.mesh_raster import rasterize_mesh as jraster
from robosimgs_tpu.render.project import project as jproject

from robosimgs_tpu_torch.core.convert import (camera_from_numpy,
                                              gaussians_from_numpy,
                                              projected_from_numpy)
from robosimgs_tpu_torch.render.binning import bin_rects, per_gaussian_cover
from robosimgs_tpu_torch.render.compose import render_composite
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.mesh_raster import (MeshRasterConfig,
                                                    rasterize_mesh)

ATOL = 1e-5
# pixels whose mask or face id may differ: pixel centers within f32
# rounding of a triangle edge, whose barycentric rounds the other way
# (XLA contracts the edge functions into FMAs, torch rounds each product)
EDGE_FRAC = 1e-3
# the default eye is nudged off the axis, as the JAX package's own
# chunk-parity test does, so that no pixel center lands exactly on the
# quads' diagonals; "quad_on_axis" keeps the exact axis
NUDGE = [0.0, 0.013, 0.021]
# relative depth / absolute rgb tolerance of the cases with vertices at
# the near plane: a vertex at z = 0.05 projects ~1e3 px off screen and a
# clip vertex at z = near * (1 + 1e-4) ~5e4 px, so a pixel's edge
# functions are differences of products up to 1e9 and keep 1e-5 to 1e-3
# of their f32 digits; XLA contracts them into FMAs, torch rounds each
# product (the two agree to ~1e-6 elsewhere)
NEAR_TOL = {"near_clip": 5e-5, "near_drop": 5e-5, "textured_near_clip": 2e-3}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcam(w=64, h=64, dist=4.0, eye=None):
    eye = eye or [dist - 0.03 + NUDGE[0], NUDGE[1], NUDGE[2]]
    return JCamera.look_at(eye, [0, 0, 0], [0, 0, 1], 60.0, w, h)


def _cam(jcam):
    return camera_from_numpy(jax.device_get(jcam), "cpu")


def unit_quad(z=0.0, size=1.0, color=(1.0, 0.0, 0.0)):
    """Two triangles spanning [-s,s]^2 in the plane x=z (facing +x)."""
    s = size
    verts = np.array([[z, -s, -s], [z, s, -s], [z, s, s], [z, -s, s]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    cols = np.tile(np.asarray(color, np.float32), (4, 1))
    return verts, faces, cols


def box_mesh(size=(0.5, 0.5, 0.2)):
    sx, sy, sz = size
    v = np.array([[x, y, z] for x in (-sx, sx) for y in (-sy, sy)
                  for z in (-sz, sz)], np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f


TEX = np.array([[[1, 0, 0], [0, 1, 0]], [[0, 0, 1], [1, 1, 1]]], np.float32)
QUAD_UV = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)


def _tetrahedra():
    """30 random tetrahedra: tiles with candidates over several chunks."""
    rng = np.random.default_rng(7)
    vs, fs, cs = [], [], []
    for i in range(30):
        c = rng.uniform(-0.7, 0.7, 3).astype(np.float32)
        s = rng.uniform(0.1, 0.5)
        vs.append((rng.uniform(-1, 1, (4, 3)) * s + c).astype(np.float32))
        fs.append(np.array([[0, 1, 2], [0, 2, 3], [0, 3, 1], [1, 3, 2]],
                           np.int32) + 4 * i)
        cs.append(np.tile(rng.uniform(0.1, 1.0, 3).astype(np.float32), (4, 1)))
    return np.concatenate(vs), np.concatenate(fs), np.concatenate(cs)


def _case(name):
    """(vertices, faces, kwargs of numpy arrays, camera, config kwargs) of
    the JAX package's tests/test_mesh_raster.py cases."""
    if name == "quad":
        v, f, c = unit_quad(size=0.8)
        return v, f, dict(vertex_colors=c), _jcam(), {}
    if name == "quad_on_axis":
        v, f, c = unit_quad(size=0.8)
        return v, f, dict(vertex_colors=c), _jcam(eye=[4.0, 0, 0]), {}
    if name == "zbuffer":
        v1, f1, c1 = unit_quad(z=0.0, size=0.8, color=(1, 0, 0))
        v2, f2, c2 = unit_quad(z=1.0, size=0.4, color=(0, 1, 0))
        return (np.concatenate([v1, v2]), np.concatenate([f1, f2 + 4]),
                dict(vertex_colors=np.concatenate([c1, c2])), _jcam(), {})
    if name == "perspective":
        v = np.array([[0.5, -1, -1], [-0.5, 1, -1], [-0.5, 1, 1],
                      [0.5, -1, 1]], np.float32)
        return v, unit_quad()[1], {}, _jcam(), {}
    if name in ("near_clip", "near_drop"):
        v, f = box_mesh((0.6, 0.6, 0.25))
        cam = JCamera.look_at([0.65, 0.0, 0.1], [-1.0, 0, 0.0], [0, 0, 1],
                              70.0, 96, 96)
        cols = np.tile(np.array([[0.8, 0.4, 0.2]], np.float32), (len(v), 1))
        return v, f, dict(vertex_colors=cols), cam, dict(
            tile_capacity=256, near=0.05, clip_near=name == "near_clip")
    if name == "textured":
        v, f, _ = unit_quad(size=0.8)
        return v, f, dict(vertex_uvs=QUAD_UV, texture=TEX), _jcam(), {}
    if name == "textured_color":
        v, f, _ = unit_quad(size=0.8)
        return v, f, dict(vertex_colors=np.full((4, 3), 0.5, np.float32),
                          vertex_uvs=np.full((4, 2), 0.5, np.float32),
                          texture=np.ones((4, 4, 3), np.float32)), _jcam(), {}
    if name == "textured_near_clip":
        v = np.array([[6.0, -1, -1], [0.0, 1, -1], [0.0, 1, 1],
                      [6.0, -1, 1]], np.float32)
        return v, unit_quad()[1], dict(vertex_uvs=QUAD_UV, texture=TEX), \
            _jcam(), {}
    if name.startswith("tri_chunk_textured"):
        v, f, _ = unit_quad(size=0.8)
        cam = JCamera.look_at([3.97, 0.013, 0.021], [0, 0, 0], [0, 0, 1],
                              60.0, 64, 64)
        return v, f, dict(vertex_uvs=QUAD_UV, texture=TEX), cam, dict(
            tile_capacity=64, tri_chunk=int(name.rsplit("_", 1)[1]))
    if name.startswith("tri_chunk"):
        v, f, c = _tetrahedra()
        return v, f, dict(vertex_colors=c), _jcam(96, 64, 3.0), dict(
            tile_capacity=96, max_tiles_per_tri=64,
            tri_chunk=int(name.rsplit("_", 1)[1]))
    raise KeyError(name)


CASES = ["quad", "zbuffer", "perspective", "near_clip", "near_drop",
         "textured", "textured_color", "textured_near_clip", "tri_chunk_0",
         "tri_chunk_32", "tri_chunk_40", "tri_chunk_96",
         "tri_chunk_textured_0", "tri_chunk_textured_16"]


def _both(name):
    v, f, kw, jcam, ckw = _case(name)
    # jitted: op-by-op JAX costs seconds a call on the CPU
    want = jax.jit(lambda v, f, kw: jraster(v, f, jcam, cfg=JMeshConfig(**ckw),
                                            **kw))(v, f, kw)
    got = rasterize_mesh(torch.from_numpy(v), torch.from_numpy(f), _cam(jcam),
                         cfg=MeshRasterConfig(**ckw),
                         **{k: torch.from_numpy(x) for k, x in kw.items()})
    return got, jax.device_get(want)


def _differing(got, want):
    """(mask, face id) of the port; pixels whose mask or face id differ
    from the JAX package's."""
    m, jm = got["mask"].numpy(), np.asarray(want["mask"])
    fid, jfid = got["face_id"].numpy(), np.asarray(want["face_id"])
    return m, jm, fid, jfid, (m != jm) | ((fid != jfid) & m & jm)


def _assert_raster_close(got, want, name=""):
    m, jm, fid, jfid, diff = _differing(got, want)
    assert diff.sum() <= EDGE_FRAC * m.size, int(diff.sum())
    same = m & jm & (fid == jfid)
    rtol = NEAR_TOL.get(name, 0.0)
    np.testing.assert_allclose(got["depth"].numpy()[same],
                               np.asarray(want["depth"])[same], atol=ATOL,
                               rtol=rtol)
    np.testing.assert_allclose(got["rgb"].numpy()[same],
                               np.asarray(want["rgb"])[same],
                               atol=max(ATOL, rtol))
    assert np.isinf(got["depth"].numpy()[~m]).all()
    assert (fid[~m] == -1).all()
    for k in ("near_clipped", "near_dropped"):
        assert int(got[k]) == int(want[k]), k
    for f in dataclasses.fields(got["stats"]):
        assert int(getattr(got["stats"], f.name)) == int(
            getattr(want["stats"], f.name)), f.name
    return same.sum()


def test_knife_edge_pixels_on_axis():
    """Seen on the axis, the quad's diagonal runs through pixel centers:
    the two packages may round those pixels' barycentrics to opposite
    sides (a pixel that both or neither triangle claims). Every pixel
    that differs lies on that diagonal, and the port leaves no crack."""
    got, want = _both("quad_on_axis")
    m, jm, fid, jfid, diff = _differing(got, want)
    rows, cols = np.nonzero(diff)
    assert (rows + cols == 63).all()
    assert 0 < diff.sum() <= 16
    inner = np.zeros_like(m)
    inner[24:40, 24:40] = True
    assert m[inner].all()
    same = m & jm & (fid == jfid)
    np.testing.assert_allclose(got["depth"].numpy()[same],
                               np.asarray(want["depth"])[same], atol=ATOL)


@pytest.mark.parametrize("name", CASES)
def test_rasterize_mesh_matches_jax(name):
    got, want = _both(name)
    assert _assert_raster_close(got, want, name) > 50
    if name in ("near_clip", "textured_near_clip"):
        assert int(got["near_clipped"]) > 0
    if name == "near_drop":
        assert int(got["near_dropped"]) > 0
    if name == "tri_chunk_0":
        assert int(got["stats"].max_tile_count) > 40   # several chunks


def test_tri_chunk_equals_unchunked():
    """Chunked z-buffering is exact against the unchunked path in the
    port too (same depths, colors and face ids, ties to the earlier
    chunk), including when K is not a chunk multiple."""
    v, f, kw, jcam, ckw = _case("tri_chunk_0")
    args = (torch.from_numpy(v), torch.from_numpy(f), _cam(jcam))
    c = torch.from_numpy(kw["vertex_colors"])
    base = MeshRasterConfig(**ckw)
    out0 = rasterize_mesh(*args, vertex_colors=c, cfg=base)
    for chunk in (32, 40, 96):
        outc = rasterize_mesh(*args, vertex_colors=c,
                              cfg=dataclasses.replace(base, tri_chunk=chunk))
        assert torch.equal(outc["mask"], out0["mask"])
        assert torch.equal(outc["face_id"], out0["face_id"])
        torch.testing.assert_close(outc["rgb"], out0["rgb"], rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(outc["depth"], out0["depth"], rtol=1e-5,
                                   atol=0)


@pytest.mark.parametrize("chunk", [0, 40])
def test_tile_groups_change_nothing(monkeypatch, chunk):
    """One tile per group (the budget below every tile's work) gives the
    same image as the default grouping."""
    from robosimgs_tpu_torch.render import mesh_raster
    v, f, kw, jcam, ckw = _case(f"tri_chunk_{chunk}")
    args = (torch.from_numpy(v), torch.from_numpy(f), _cam(jcam))
    kw = {k: torch.from_numpy(x) for k, x in kw.items()}
    cfg = MeshRasterConfig(**ckw)
    out0 = rasterize_mesh(*args, cfg=cfg, **kw)
    monkeypatch.setattr(mesh_raster, "_GROUP_ELEMS", {"cpu": 1})
    out1 = rasterize_mesh(*args, cfg=cfg, **kw)
    for k in ("rgb", "depth", "mask", "face_id"):
        assert torch.equal(out0[k], out1[k]), k


@pytest.mark.parametrize("chunk", [0, 1])
def test_rasterize_mesh_vertex_grad_matches_jax(chunk):
    """Vertex gradients through the z-buffer's barycentrics and 1/z
    against jax.grad, unchunked and one candidate per chunk."""
    v, f, _ = unit_quad(size=0.8)
    cols = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0]], np.float32)
    jcam = _jcam(32, 32, eye=[4.0, 0.3, 0.2])
    wts = np.random.default_rng(0).uniform(0, 1, (32, 32, 3)).astype(np.float32)

    def jloss(verts):
        out = jraster(verts, jnp.asarray(f), jcam, vertex_colors=jnp.asarray(cols),
                      cfg=JMeshConfig(tri_chunk=chunk))
        return (jnp.sum(out["rgb"] * wts)
                + jnp.sum(jnp.where(out["mask"], out["depth"], 0.0)))

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(v)))
    vt = torch.from_numpy(v).requires_grad_()
    out = rasterize_mesh(vt, torch.from_numpy(f), _cam(jcam),
                         vertex_colors=torch.from_numpy(cols),
                         cfg=MeshRasterConfig(tri_chunk=chunk))
    loss = ((out["rgb"] * torch.from_numpy(wts)).sum()
            + torch.where(out["mask"], out["depth"], 0.0).sum())
    loss.backward()
    got = vt.grad.numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_bin_rects_bit_equal(seed):
    """Random rects with empty, invalid, truncated (cover > M) and
    overflowing (count > K) cases; ranks a permutation."""
    rng = np.random.default_rng(seed)
    n, tx, ty = 300, 6, 5
    x0 = rng.integers(-1, tx, n)
    y0 = rng.integers(0, ty, n)
    x1 = np.minimum(x0 + rng.integers(-1, 4, n), tx - 1)
    y1 = np.minimum(y0 + rng.integers(0, 3, n), ty - 1)
    x0 = np.maximum(x0, 0)
    rank = rng.permutation(n)
    valid = rng.uniform(size=n) > 0.1
    M, K = 6, 20
    arrs = [a.astype(np.int32) for a in (x0, y0, x1, y1, rank)]
    jsel, jcounts, jstats = jax.device_get(jax.jit(
        lambda *a: jbinning.bin_rects(*a, tx, ty, M, K))(*arrs, valid))
    sel, counts, stats = bin_rects(*[torch.from_numpy(a).long() for a in arrs],
                                   torch.from_numpy(valid), tx, ty, M, K)
    np.testing.assert_array_equal(sel.numpy(), jsel)
    np.testing.assert_array_equal(counts.numpy(), jcounts)
    for f in dataclasses.fields(stats):
        assert int(getattr(stats, f.name)) == int(getattr(jstats, f.name))
    assert int(stats.overflowed_tiles) > 0 and int(stats.truncated_gaussians) > 0


@pytest.mark.parametrize("cull", [True, False])
def test_per_gaussian_cover_bit_equal(cull):
    g = JGaussians.random(jax.random.PRNGKey(3), 200, sh_degree=1)
    g = g.replace(log_scales=g.log_scales + 1.5)    # several tiles each
    jcam = JCamera.look_at([3.0, 0.5, 1.0], [0, 0, 0], [0, 0, 1], 55.0, 64, 48)
    jcfg = JConfig(exact_tile_cull=cull)
    jp = jproject(g, jcam, jcfg)
    want = np.asarray(jax.jit(lambda p: jbinning.per_gaussian_cover(
        p, 64, 48, jcfg, 40))(jp))
    got = per_gaussian_cover(projected_from_numpy(jax.device_get(jp), "cpu"),
                             64, 48, RenderConfig(exact_tile_cull=cull), 40)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 4


@pytest.mark.parametrize("impl", ["reference", "tiled"])
def test_render_composite_matches_jax(impl):
    """A quad in front of random splats: the mesh depth culls splats
    behind it per pixel (test_mesh_raster.py's depth-limit case)."""
    jg = JGaussians.random(jax.random.PRNGKey(2), 80, sh_degree=1)
    jcam = _jcam(48, 48)
    v, f, col = unit_quad(z=0.0, size=0.5, color=(0.5, 0.5, 0.5))
    kw = dict(tile_capacity=128, max_tiles_per_gaussian=64)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    want = jax.jit(lambda g, m: jcomposite(
        g, jcam, [m], JConfig(**kw), background=jnp.asarray(bg),
        impl=impl))(jg, (v, f, col))
    got = render_composite(
        gaussians_from_numpy(jax.device_get(jg), "cpu"), _cam(jcam),
        [tuple(torch.from_numpy(x) for x in (v, f, col))], RenderConfig(**kw),
        background=torch.from_numpy(bg), impl=impl)
    for k in ("rgb", "alpha", "splat_depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, err_msg=k)
    np.testing.assert_array_equal(got["mesh_mask"].numpy(),
                                  np.asarray(want["mesh_mask"]))
    m = got["mesh_mask"].numpy()
    assert m.any() and (~m).any() and float(got["alpha"].max()) > 0.3


def test_render_composite_without_meshes():
    jg = JGaussians.random(jax.random.PRNGKey(0), 5, sh_degree=0)
    g = gaussians_from_numpy(jax.device_get(jg), "cpu")
    g = g.replace(alive=torch.zeros_like(g.alive))
    out = render_composite(g, _cam(_jcam(32, 32)), [],
                           background=torch.tensor([0.1, 0.2, 0.3]))
    np.testing.assert_allclose(out["rgb"].numpy()[0, 0], [0.1, 0.2, 0.3],
                               atol=1e-6)
    assert not bool(out["mesh_mask"].any())
    with pytest.raises(ValueError, match="impl"):
        render_composite(g, _cam(_jcam(32, 32)), [], impl="bogus")
