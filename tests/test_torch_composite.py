"""Compositing forward parity: the port's composite_fwd (its plain torch
version on the CPU) against the JAX package's Pallas kernel in interpret
mode and its gathered jnp oracle, on identical seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosimgs_tpu.render.config import RenderConfig as JConfig
from robosimgs_tpu.render.gathered import composite_gathered as jgathered
from robosimgs_tpu.render.pallas_kernels import composite_fwd_pallas

from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.gathered import composite_gathered
from robosimgs_tpu_torch.render.kernels import (LT_GROUP, composite_fwd,
                                                composite_fwd_plain)

TS, P = 16, 256
TILES_X = 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_inputs(counts, K, n_img=None, seed=0, saturate=(), ts=TS):
    """Gathered (T,8,K) blocks as the binner lays them out for ts x ts
    tiles: splats near their tile, opacity 0 past counts[t]. Tiles in
    `saturate` get near-opaque splats covering the whole tile."""
    rng = np.random.default_rng(seed)
    T = len(counts)
    n_img = n_img or T
    geom = np.zeros((T, 8, K), np.float32)
    t_img = np.arange(T) % n_img
    ox = (t_img % TILES_X) * ts
    oy = (t_img // TILES_X) * ts
    geom[:, 0] = ox[:, None] + rng.uniform(-6, ts + 6, (T, K))
    geom[:, 1] = oy[:, None] + rng.uniform(-6, ts + 6, (T, K))
    sx = rng.uniform(1.0, 7.0, (T, K))
    sy = rng.uniform(1.0, 7.0, (T, K))
    rho = rng.uniform(-0.6, 0.6, (T, K))
    cxy = rho * sx * sy
    det = sx * sx * sy * sy - cxy * cxy
    geom[:, 2] = sy * sy / det
    geom[:, 3] = -cxy / det
    geom[:, 4] = sx * sx / det
    geom[:, 5] = rng.uniform(0.05, 0.99, (T, K))
    geom[:, 6] = np.sort(rng.uniform(1.0, 5.0, (T, K)), axis=1)
    for t in saturate:
        geom[t, 0] = ox[t] + ts / 2
        geom[t, 1] = oy[t] + ts / 2
        geom[t, 2:5] = np.array([1e-3, 0.0, 1e-3])[:, None]
        geom[t, 5] = 0.99
    pad = np.arange(K)[None, :] >= np.asarray(counts)[:, None]
    geom[:, 5][pad] = 0.0
    feat = rng.uniform(0.0, 1.0, (T, 8, K)).astype(np.float32)
    dlim = rng.uniform(1.0, 5.0, (T, ts * ts, 1)).astype(np.float32)
    dlim[:, ::7] = np.inf
    return geom, feat, np.asarray(counts, np.int32), dlim


def run_both(geom, feat, counts, dlim, kw, n_img=0, has_dlim=True):
    jout, jtfin, jnblk = composite_fwd_pallas(
        jnp.asarray(geom), jnp.asarray(feat), jnp.asarray(counts),
        jnp.asarray(dlim), tiles_x=TILES_X, cfg=JConfig(**kw), interpret=True,
        n_tiles_per_image=n_img, has_dlim=has_dlim)
    t = torch.from_numpy
    # the Pallas kernel has no log_t_groups: compare the first three
    out, tfin, nblk, _ = composite_fwd(
        t(geom), t(feat), t(counts), t(dlim) if has_dlim else None,
        tiles_x=TILES_X, cfg=RenderConfig(**kw), n_tiles_per_image=n_img,
        has_dlim=has_dlim)
    return (np.asarray(jout), np.asarray(jtfin), np.asarray(jnblk)), \
        (out.numpy(), tfin.numpy(), nblk.numpy())


def assert_matches(jres, res):
    (jout, jtfin, jnblk), (out, tfin, nblk) = jres, res
    np.testing.assert_array_equal(nblk, jnblk)
    np.testing.assert_allclose(out, jout, atol=1e-5, rtol=1e-5)
    # log-T: atol 1e-4, plus rtol 1e-5 because saturated pixels sum 128
    # terms to about -350, where one f32 ulp is 3e-5 and the two sides
    # sum in different orders (an MXU-form matmul against a cumsum)
    np.testing.assert_allclose(tfin, jtfin, atol=1e-4, rtol=1e-5)


# an empty tile, counts that are not multiples of 128, a full tile
COUNTS = [0, 57, 200, 256, 129, 1]


@pytest.mark.parametrize("has_dlim", [False, True])
def test_composite_fwd_matches_pallas(has_dlim):
    geom, feat, counts, dlim = make_inputs(COUNTS, 256)
    jres, res = run_both(geom, feat, counts, dlim, {}, has_dlim=has_dlim)
    assert_matches(jres, res)
    assert res[2][0] == 0 and (res[0][0] == 0).all()        # empty tile
    assert (res[2][1:] >= 1).all()
    # the gathered oracle (cumulative log-T) agrees on the image
    gout = composite_gathered(
        torch.from_numpy(geom), torch.from_numpy(feat),
        torch.from_numpy(counts), TILES_X, RenderConfig(),
        torch.from_numpy(dlim[..., 0]) if has_dlim else None)
    np.testing.assert_allclose(gout.numpy(), res[0], atol=1e-5, rtol=1e-5)
    jg = jgathered(jnp.asarray(geom), jnp.asarray(feat), jnp.asarray(counts),
                   TILES_X, JConfig(),
                   jnp.asarray(dlim[..., 0]) if has_dlim else None)
    np.testing.assert_allclose(gout.numpy(), np.asarray(jg), atol=1e-5,
                               rtol=1e-5)


def test_composite_fwd_matches_pallas_on_32x32_tiles():
    """tile_size 32, the JAX package's tile for its 3M-Gaussian config:
    1024 pixels a tile, one CUDA thread each."""
    geom, feat, counts, dlim = make_inputs(COUNTS, 256, seed=7, ts=32)
    jres, res = run_both(geom, feat, counts, dlim, dict(tile_size=32))
    assert_matches(jres, res)
    assert res[0].shape == (6, 8, 1024) and (res[2][1:] >= 1).all()


def test_composite_fwd_multi_image_batch():
    """n_tiles_per_image: two 6-tile images concatenated on the tile axis
    share pixel coordinates tile by tile."""
    geom, feat, counts, dlim = make_inputs(COUNTS + COUNTS[::-1], 256,
                                           n_img=6, seed=1)
    jres, res = run_both(geom, feat, counts, dlim, {}, n_img=6)
    assert_matches(jres, res)
    t_idx = torch.arange(12) % 6
    gout = composite_gathered(
        torch.from_numpy(geom), torch.from_numpy(feat),
        torch.from_numpy(counts), TILES_X, RenderConfig(),
        torch.from_numpy(dlim[..., 0]), t_idx=t_idx)
    np.testing.assert_allclose(gout.numpy(), res[0], atol=1e-5, rtol=1e-5)


def test_composite_fwd_saturated_tile_stops_early():
    """>= 300 near-opaque splats: every pixel saturates in the first
    block, so the tile stops with nblk < ceil(count / 128), and log-T
    keeps summing over the whole processed block (exact where linear T
    underflows)."""
    counts = [320, 384, 100, 0, 300, 5]
    geom, feat, counts, dlim = make_inputs(counts, 384, seed=2,
                                           saturate=(0, 1, 4))
    jres, res = run_both(geom, feat, counts, dlim, {}, has_dlim=False)
    assert_matches(jres, res)
    nblk = res[2]
    assert nblk[0] == 1 and nblk[1] == 1 and nblk[4] == 1
    assert (res[1][0] < -100).all()          # log T far below f32 exp range


@pytest.mark.parametrize("chunk", [128, 384])
def test_tile_chunk_is_valid_noop(chunk):
    geom, feat, counts, dlim = make_inputs([384, 10, 0, 200, 300, 129], 384,
                                           seed=3)
    jres, res = run_both(geom, feat, counts, dlim, dict(tile_chunk=chunk))
    assert_matches(jres, res)
    _, base = run_both(geom, feat, counts, dlim, {})
    for a, b in zip(res, base):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chunk,K,msg", [
    (100, 256, "tile_chunk 100 must be a multiple of 128"),
    (256, 384, "tile_capacity 384 must be a multiple of tile_chunk 256"),
    (0, 200, "tile_chunk 200 must be a multiple of 128"),
])
def test_tile_chunk_validation_errors(chunk, K, msg):
    geom, feat, counts, dlim = make_inputs([K, 0, 1, 2, 3, 4], K)
    with pytest.raises(ValueError, match=msg):
        composite_fwd_pallas(jnp.asarray(geom), jnp.asarray(feat),
                             jnp.asarray(counts), jnp.asarray(dlim),
                             tiles_x=TILES_X, cfg=JConfig(tile_chunk=chunk),
                             interpret=True)
    t = torch.from_numpy
    with pytest.raises(ValueError, match=msg):
        composite_fwd(t(geom), t(feat), t(counts), t(dlim), tiles_x=TILES_X,
                      cfg=RenderConfig(tile_chunk=chunk))


def test_alpha_mxu_is_accepted_and_evaluated_per_pixel():
    geom, feat, counts, dlim = make_inputs(COUNTS, 256, seed=4)
    t = torch.from_numpy
    args = (t(geom), t(feat), t(counts), t(dlim))
    a = composite_fwd(*args, tiles_x=TILES_X, cfg=RenderConfig(alpha_mxu=True))
    b = composite_fwd_plain(*args, tiles_x=TILES_X, cfg=RenderConfig())
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_composite_fwd_rejects_bad_inputs():
    geom, feat, counts, dlim = make_inputs([3] * 6, 128)
    t = torch.from_numpy
    cfg = RenderConfig()
    with pytest.raises(ValueError, match="int32"):
        composite_fwd(t(geom), t(feat), t(counts).long(), t(dlim),
                      tiles_x=TILES_X, cfg=cfg)
    with pytest.raises(ValueError, match="dlim"):
        composite_fwd(t(geom), t(feat), t(counts), None, tiles_x=TILES_X,
                      cfg=cfg)
    with pytest.raises(ValueError, match="contiguous"):
        composite_fwd(t(geom).transpose(0, 2).contiguous().transpose(0, 2),
                      t(feat), t(counts), t(dlim), tiles_x=TILES_X, cfg=cfg)
    with pytest.raises(ValueError, match="float32"):
        composite_fwd(t(geom).double(), t(feat), t(counts), t(dlim),
                      tiles_x=TILES_X, cfg=cfg)


def np_alpha(geom, counts, dlim, cfg, n_img=None):
    """Masked alpha (T, P, K) in numpy f32, in tile_alpha's order of
    operations."""
    T, _, K = geom.shape
    t_img = np.arange(T) % (n_img or T)
    p = np.arange(P)
    px = ((t_img % TILES_X)[:, None] * TS + p % TS).astype(np.float32)
    py = ((t_img // TILES_X)[:, None] * TS + p // TS).astype(np.float32)
    g = geom[:, :, None, :]
    dx = px[:, :, None] - g[:, 0]
    dy = py[:, :, None] - g[:, 1]
    q = np.float32(0.5) * (g[:, 2] * dx * dx + g[:, 4] * dy * dy) \
        + g[:, 3] * dx * dy
    alpha = np.minimum(g[:, 5] * np.exp(-q), np.float32(cfg.alpha_clamp))
    keep = (alpha >= cfg.alpha_min) & (q >= 0) \
        & (np.arange(K)[None, None, :] < counts[:, None, None])
    if dlim is not None:
        keep &= g[:, 6] <= dlim[:, :, None]
    return np.where(keep, alpha, np.float32(0.0))


@pytest.mark.parametrize("case", ["plain", "dlim", "saturated"])
def test_log_t_groups_is_the_running_sum_at_group_ends(case):
    """log_t_groups[t, (128 / LT_GROUP) b + g] is block b's running sum of
    log1p(-alpha) over its kept slots at the end of its LT_GROUP-slot group
    g (0 past the processed blocks in the plain version), and the processed
    blocks' last group ends sum to log_t_final."""
    if case == "saturated":
        geom, feat, counts, dlim = make_inputs([320, 384, 100, 0, 300, 5],
                                               384, seed=2,
                                               saturate=(0, 1, 4))
    else:
        geom, feat, counts, dlim = make_inputs(COUNTS, 256, seed=6)
    has_dlim = case == "dlim"
    cfg = RenderConfig()
    t = torch.from_numpy
    _, tfin, nblk, ltg = (x.numpy() for x in composite_fwd(
        t(geom), t(feat), t(counts), t(dlim) if has_dlim else None,
        tiles_x=TILES_X, cfg=cfg, has_dlim=has_dlim))
    T, _, K = geom.shape
    G = 128 // LT_GROUP
    assert ltg.shape == (T, K // LT_GROUP, P) and ltg.dtype == np.float32
    lg = np.log1p(-np_alpha(geom, counts, dlim[..., 0] if has_dlim else None,
                            cfg).astype(np.float64))
    want = np.zeros((T, K // LT_GROUP, P))
    for b in range(K // 128):
        run = np.cumsum(lg[:, :, b * 128:(b + 1) * 128], axis=2)
        ends = run[:, :, LT_GROUP - 1::LT_GROUP].transpose(0, 2, 1)
        want[:, G * b:G * (b + 1)] = np.where((nblk > b)[:, None, None], ends,
                                              0)
    np.testing.assert_allclose(ltg, want, atol=1e-5, rtol=1e-5)
    last = ltg[:, G - 1::G].sum(axis=1)
    np.testing.assert_allclose(last, tfin[:, :, 0], atol=1e-5, rtol=1e-5)
    if case == "saturated":
        assert nblk[0] == 1 and (ltg[0, G:] == 0).all()
        assert (ltg[0, G - 1] < -100).all()
