"""Compositing backward parity: the port's composite_bwd (its plain torch
version on the CPU) against the JAX package's Pallas backward in
interpret mode, both fed the Pallas forward's residuals (log_t_final,
nblk) and the same seeded cotangent, on per-tile blocks the JAX
package's own pipeline (project + bin_and_gather_packed) builds from
its seeded scenes; and the autograd op `Composite` against torch
autograd of the gathered oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosimgs_tpu.core.camera import Camera as JCamera
from robosimgs_tpu.core.types import Gaussians as JGaussians
from robosimgs_tpu.render.binning import bin_and_gather_packed as jbin
from robosimgs_tpu.render.config import RenderConfig as JConfig
from robosimgs_tpu.render.gathered import composite_gathered as jgathered
from robosimgs_tpu.render.pallas_kernels import (composite_bwd_pallas,
                                                composite_fwd_pallas)
from robosimgs_tpu.render.project import project as jproject

from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.gathered import composite_gathered
from robosimgs_tpu_torch.render.kernels import (BK, MAX_SPLITS, Composite,
                                                bwd_splits, composite_bwd,
                                                composite_bwd_plain,
                                                composite_fwd, split_range)
from test_torch_composite import COUNTS, P, TILES_X, make_inputs

# test_tiled.py:117-120's tolerances for the hand-derived backward. The
# Pallas kernel forms its geometry rows from tile-local pixel moments
# (sum dq x^2 - 2 mx sum dq x + ...), whose f32 cancellation is below
# these on the pipeline's blocks.
ATOL, RTOL = 1e-4, 1e-3
CFG = dict(tile_capacity=256, max_tiles_per_gaussian=64)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def camera(eye, w, h, fov=60.0):
    return JCamera.look_at(eye, [0, 0, 0], [0, 0, 1], fov, w, h)


def blocks(g, cam, kw, absgrad=False):
    """The JAX pipeline's (geom, feat, counts) numpy blocks of one view."""
    cfg = JConfig(**kw)

    @jax.jit
    def pipeline(g):
        probe = jnp.zeros((g.capacity, 2)) if absgrad else None
        return jbin(jproject(g, cam, cfg, abs_probe=probe), cam.width,
                    cam.height, cfg)

    geom, feat, counts, stats = pipeline(g)
    assert int(stats.overflowed_tiles) == 0
    return np.array(geom), np.array(feat), np.array(counts)


def cotangent(T, P, seed):
    """N(0, 1) on the rgb, depth and alpha rows, 0 on rows 5..7 as the
    losses give."""
    gout = np.random.default_rng(100 + seed).normal(
        size=(T, 8, P)).astype(np.float32)
    gout[:, 5:] = 0.0
    return gout


def run_both(geom, feat, counts, tiles_x, kw, dlim=None, n_img=0, seed=0):
    """(jax (dgeom, dfeat), port (dgeom, dfeat), nblk) from the same
    inputs, Pallas forward residuals and cotangent (`cotangent`)."""
    T = geom.shape[0]
    gout = cotangent(T, JConfig(**kw).tile_size ** 2, seed)
    has_dlim = dlim is not None
    j = jnp.asarray
    jdlim = j(dlim) if has_dlim else jnp.full((T, P, 1), jnp.inf)
    opts = dict(tiles_x=tiles_x, cfg=JConfig(**kw), interpret=True,
                n_tiles_per_image=n_img, has_dlim=has_dlim)
    args = (j(geom), j(feat), j(counts), jdlim)
    _, tfin, nblk = composite_fwd_pallas(*args, **opts)
    jd = composite_bwd_pallas(*args, j(gout), tfin, nblk, **opts)
    t = torch.from_numpy
    # the Pallas forward has no log_t_groups: the plain version takes None
    d = composite_bwd(t(geom), t(feat), t(counts), t(dlim) if has_dlim else None,
                      t(gout), t(np.array(tfin)), t(np.array(nblk)), None,
                      tiles_x=tiles_x, cfg=RenderConfig(**kw),
                      n_tiles_per_image=n_img, has_dlim=has_dlim)
    return tuple(np.asarray(x) for x in jd), tuple(x.numpy() for x in d), \
        np.asarray(nblk)


def assert_matches(jd, d, absgrad=False):
    """dgeom rows 0..5 and dfeat rows 0..3 (+ both rows 7 under absgrad,
    which own them); the rest is 0 on both sides here."""
    (jg, jf), (g, f) = jd, d
    rows_g = [0, 1, 2, 3, 4, 5] + ([7] if absgrad else [])
    rows_f = [0, 1, 2, 3] + ([7] if absgrad else [])
    np.testing.assert_allclose(g[:, rows_g], jg[:, rows_g], atol=ATOL,
                               rtol=RTOL, err_msg="dgeom")
    np.testing.assert_allclose(f[:, rows_f], jf[:, rows_f], atol=ATOL,
                               rtol=RTOL, err_msg="dfeat")
    assert (g[:, 6] == 0).all()
    if not absgrad:
        assert (g[:, 7] == 0).all()


def test_composite_bwd_matches_pallas_default():
    """test_tiled.py:87's scene: 80 Gaussians, 48x32."""
    g = JGaussians.random(jax.random.PRNGKey(5), 80, sh_degree=1)
    geom, feat, counts = blocks(g, camera([4.0, 0.3, 0.8], 48, 32), CFG)
    jd, d, nblk = run_both(geom, feat, counts, 3, CFG)
    assert_matches(jd, d)
    dgeom, dfeat = d
    assert np.abs(dgeom[:, :6]).max() > 1e-2 and (nblk >= 1).any()
    # slots past a tile's count (opacity 0) get zero on every row, so
    # binner padding leaks no gradient into the Gaussian it points at
    pad = np.arange(geom.shape[2])[None, :] >= counts[:, None]
    assert pad.any()
    assert (np.abs(dgeom).sum(1)[pad] == 0).all()
    assert (np.abs(dfeat).sum(1)[pad] == 0).all()


def test_composite_bwd_matches_pallas_dlim_two_images():
    """Two views of one scene concatenated on the tile axis
    (n_tiles_per_image) with a random depth limit, inf on some pixels."""
    g = JGaussians.random(jax.random.PRNGKey(6), 120, sh_degree=1)
    b1 = blocks(g, camera([4.0, 0.3, 0.8], 48, 32), CFG)
    b2 = blocks(g, camera([-3.0, 2.5, 1.0], 48, 32), CFG)
    geom, feat, counts = (np.concatenate([x, y]) for x, y in zip(b1, b2))
    T = geom.shape[0]
    rng = np.random.default_rng(1)
    dlim = rng.uniform(3.0, 5.0, (T, P, 1)).astype(np.float32)
    dlim[:, ::7] = np.inf
    jd, d, _ = run_both(geom, feat, counts, 3, CFG, dlim=dlim, n_img=T // 2,
                        seed=1)
    assert_matches(jd, d)


def test_composite_bwd_matches_pallas_absgrad():
    """test_tiled.py:246's setting: the abs_probe rides geom/feat rows 7."""
    kw = dict(CFG, absgrad=True)
    g = JGaussians.random(jax.random.PRNGKey(5), 60, sh_degree=1)
    geom, feat, counts = blocks(g, camera([3.0, 0.4, 0.8], 48, 32), kw,
                                absgrad=True)
    jd, d, _ = run_both(geom, feat, counts, 3, kw, seed=2)
    assert_matches(jd, d, absgrad=True)
    dgeom, dfeat = d
    # rows 7 hold per-pixel |screen grad| sums: >= the signed sums
    assert (dgeom[:, 7] >= np.abs(dgeom[:, 0]) - 1e-5).all()
    assert (dfeat[:, 7] >= np.abs(dgeom[:, 1]) - 1e-5).all()
    assert dgeom[:, 7].max() > 1e-2


def test_composite_bwd_matches_pallas_saturated():
    """test_tiled.py:390's scene: 64 stacked near-opaque splats, whose
    pixels' linear T underflows to 0 in the forward; the backward
    rebuilds T from log-T and the front splats' gradients are not zero."""
    n = 64
    g = JGaussians.random(jax.random.PRNGKey(0), n, sh_degree=1)
    means = np.zeros((n, 3), np.float32)
    means[:, 0] = np.linspace(-0.01, 0.01, n)
    g = g.replace(means=jnp.asarray(means),
                  logit_opacities=jnp.full((n,), 6.0))
    kw = dict(tile_capacity=128)
    geom, feat, counts = blocks(g, camera([2.5, 0.0, 0.0], 32, 32, 45.0), kw)
    jd, d, _ = run_both(geom, feat, counts, 2, kw, seed=3)
    assert_matches(jd, d)
    dgeom, dfeat = d
    assert counts.max() >= 60
    assert np.abs(dgeom[:, :6]).max() > 0.1
    assert np.abs(dfeat[:, :4]).max() > 0.1


def test_composite_bwd_matches_pallas_chunked():
    """test_tiled.py:149's scene: capacity 512 streamed by the Pallas
    kernel as 128-entry chunks with carried state; the port sweeps the
    whole capacity."""
    kw = dict(tile_capacity=512, tile_chunk=128, max_tiles_per_gaussian=64)
    g = JGaussians.random(jax.random.PRNGKey(9), 400, sh_degree=1)
    geom, feat, counts = blocks(g, camera([5.0, 0.3, 0.8], 32, 32), kw)
    assert counts.max() > 128
    jd, d, nblk = run_both(geom, feat, counts, 2, kw, seed=4)
    assert nblk.max() >= 2
    assert_matches(jd, d)


@pytest.mark.parametrize("tile_size", [32, 12])
def test_composite_bwd_matches_pallas_on_large_and_ragged_tiles(tile_size):
    """32x32 tiles (the JAX package's 3M-Gaussian config) and ragged
    12x12 ones (144 pixels, a partial warp), which the card runs through
    its split kernel: the plain version against the Pallas backward on
    the pipeline's blocks, some tiles past one 128-splat block."""
    kw = dict(tile_size=tile_size, tile_capacity=512,
              max_tiles_per_gaussian=64)
    g = JGaussians.random(jax.random.PRNGKey(7), 400, sh_degree=1)
    geom, feat, counts = blocks(g, camera([4.0, 0.3, 0.8], 64, 48), kw)
    tiles_x = -(-64 // tile_size)
    jd, d, nblk = run_both(geom, feat, counts, tiles_x, kw, seed=5)
    assert nblk.max() >= 2
    assert np.abs(d[0][:, :6]).max() > 1e-2
    if tile_size <= 16:
        assert_matches(jd, d)
        return
    # The Pallas kernel forms the conic rows 2..4 from tile-local pixel
    # moments (sum dq x^2 - 2 mx sum dq x + mx^2 sum dq, x up to 31 here),
    # whose f32 cancellation at 32-px tiles passes these tolerances on a
    # few slots of these blocks. Those rows are held at the same
    # tolerances against jax.vjp of the JAX package's gathered compositor
    # (per-pixel products, as the port sums them) and against the plain
    # version in float64; every other row against the Pallas kernel.
    np.testing.assert_allclose(d[0][:, [0, 1, 5]], jd[0][:, [0, 1, 5]],
                               atol=ATOL, rtol=RTOL, err_msg="dgeom")
    np.testing.assert_allclose(d[1][:, :4], jd[1][:, :4], atol=ATOL,
                               rtol=RTOL, err_msg="dfeat")
    assert (d[0][:, 6:] == 0).all()
    _, vjp = jax.vjp(jax.jit(lambda gm: jgathered(
        gm, jnp.asarray(feat), jnp.asarray(counts), tiles_x, JConfig(**kw))),
        jnp.asarray(geom))
    want = np.asarray(vjp(jnp.asarray(cotangent(geom.shape[0],
                                                 tile_size ** 2, 5)))[0])
    np.testing.assert_allclose(d[0][:, 2:5], want[:, 2:5], atol=ATOL,
                               rtol=RTOL, err_msg="conic rows")
    gout = cotangent(geom.shape[0], tile_size ** 2, 5)
    _, tfin, nb = composite_fwd_pallas(
        jnp.asarray(geom), jnp.asarray(feat), jnp.asarray(counts),
        jnp.full((geom.shape[0], tile_size ** 2, 1), jnp.inf), tiles_x=tiles_x,
        cfg=JConfig(**kw), interpret=True, has_dlim=False)
    t = torch.from_numpy
    exact = composite_bwd_plain(
        t(geom).double(), t(feat).double(), t(counts), None, t(gout).double(),
        t(np.array(tfin)).double(), t(np.array(nb)), None, tiles_x=tiles_x,
        cfg=RenderConfig(**kw), has_dlim=False)[0].numpy()
    np.testing.assert_allclose(d[0][:, 2:5], exact[:, 2:5], atol=ATOL,
                               rtol=RTOL, err_msg="conic rows, float64")


@pytest.mark.parametrize("splits", range(1, MAX_SPLITS + 1))
def test_split_ranges_cover_every_block_once_in_order(splits):
    """The split kernel's rule: for any count of processed blocks, the
    ranges of a tile's blocks, rank by rank, tile [0, nblk) in order."""
    for nb in range(0, 14464 // BK + 1):
        ranges = [split_range(nb, r, splits) for r in range(splits)]
        assert ranges[0][0] == 0 and ranges[-1][1] == nb
        assert all(lo <= hi for lo, hi in ranges)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        covered = [i for lo, hi in ranges for i in range(lo, hi)]
        assert covered == list(range(nb))


@pytest.mark.parametrize("T,K,P,want", [
    (64, 14464, 1024, 4),    # the bench view at 32x32 (recommend_capacities)
    (256, 2048, 1024, 1),    # the 3M-Gaussian 512x512 config
    (4, 2048, 1024, 8),      # capped at one cluster of the portable size
    (4, 384, 144, 3),        # capped at K / BK
    (4096, 2048, 1024, 1),   # more tiles than the card holds at once
    (256, 384, 256, 1),      # 16x16 tiles: one block a tile
    (16, 384, 64, 1),        # 8x8 tiles: whole warps too
])
def test_bwd_splits(T, K, P, want):
    """Blocks per tile from the shapes and the SM count (132 on an H100
    SXM): the most that keeps T x splits within twice the SMs, unless
    capped, and one for whole-warp tiles up to 16x16."""
    splits = bwd_splits(T, K, P, 132)
    assert splits == want
    if 1 < splits < min(K // BK, MAX_SPLITS):
        assert T * splits <= 2 * 132 < T * (splits + 1)


@pytest.mark.parametrize("has_dlim", [False, True])
def test_composite_autograd_matches_gathered_autograd(has_dlim):
    geom, feat, counts, dlim = make_inputs(COUNTS, 256, seed=5)
    gout = torch.from_numpy(np.random.default_rng(5).normal(
        size=(6, 8, P)).astype(np.float32))
    cfg = RenderConfig()

    def grads(fn):
        g = torch.from_numpy(geom).requires_grad_()
        f = torch.from_numpy(feat).requires_grad_()
        out = fn(g, f)
        (out * gout).sum().backward()
        return out.detach().numpy(), g.grad.numpy(), f.grad.numpy()

    t = torch.from_numpy
    dl = t(dlim) if has_dlim else None
    got = grads(lambda g, f: Composite.apply(g, f, t(counts), dl, TILES_X, cfg,
                                             0, has_dlim))
    want = grads(lambda g, f: composite_gathered(
        g, f, t(counts), TILES_X, cfg, dl[..., 0] if has_dlim else None))
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[1][:, :6], want[1][:, :6], atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got[2], want[2], atol=ATOL, rtol=RTOL)


def test_composite_bwd_rejects_bad_inputs():
    geom, feat, counts, dlim = make_inputs([3] * 6, 128)
    t = torch.from_numpy
    out, tfin, nblk, ltg = composite_fwd(t(geom), t(feat), t(counts), t(dlim),
                                         tiles_x=TILES_X, cfg=RenderConfig())
    kw = dict(tiles_x=TILES_X, cfg=RenderConfig())
    with pytest.raises(ValueError, match="gout"):
        composite_bwd(t(geom), t(feat), t(counts), t(dlim), out[:, :4], tfin,
                      nblk, ltg, **kw)
    with pytest.raises(ValueError, match="nblk"):
        composite_bwd(t(geom), t(feat), t(counts), t(dlim), out, tfin,
                      nblk.long(), ltg, **kw)
    with pytest.raises(ValueError, match="log_t_final"):
        composite_bwd(t(geom), t(feat), t(counts), t(dlim), out, tfin[:, :, 0],
                      nblk, ltg, **kw)


@pytest.mark.parametrize("bad", ["shape", "dtype", "layout"])
def test_composite_bwd_rejects_bad_log_t_groups(bad):
    geom, feat, counts, dlim = make_inputs([3] * 6, 256)
    t = torch.from_numpy
    out, tfin, nblk, ltg = composite_fwd(t(geom), t(feat), t(counts), t(dlim),
                                         tiles_x=TILES_X, cfg=RenderConfig())
    ltg = {"shape": ltg[:, :4], "dtype": ltg.double(),
           "layout": ltg.transpose(1, 2).contiguous().transpose(1, 2)}[bad]
    with pytest.raises(ValueError, match="log_t_groups|contiguous"):
        composite_bwd(t(geom), t(feat), t(counts), t(dlim), out, tfin, nblk,
                      ltg, tiles_x=TILES_X, cfg=RenderConfig())


@pytest.mark.parametrize("has_dlim", [False, True])
def test_composite_bwd_plain_with_log_t_groups_equals_without(has_dlim):
    """The plain backward takes each block's sum from log_t_groups where
    it is given: from the plain forward's residuals, the same numbers it
    recomputes without them, saturated tiles included."""
    geom, feat, counts, dlim = make_inputs([320, 384, 100, 0, 300, 200], 384,
                                           seed=7, saturate=(0, 4))
    t = torch.from_numpy
    dl = t(dlim) if has_dlim else None
    kw = dict(tiles_x=TILES_X, cfg=RenderConfig(), has_dlim=has_dlim)
    out, tfin, nblk, ltg = composite_fwd(t(geom), t(feat), t(counts), dl, **kw)
    assert (nblk >= 2).any() and (nblk == 1).any()
    gout = torch.from_numpy(np.random.default_rng(7).normal(
        size=tuple(out.shape)).astype(np.float32))
    args = (t(geom), t(feat), t(counts), dl, gout, tfin, nblk)
    with_ltg = composite_bwd_plain(*args, ltg, **kw)
    without = composite_bwd_plain(*args, None, **kw)
    for a, b in zip(with_ltg, without):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert float(with_ltg[0][:, :6].abs().max()) > 1e-3
