"""The forward kernel's cluster split, on the CPU: the bands of pixel rows
that render/kernels.py::fwd_bands gives each block of a tile, and the
quadrant cross-check of tools/quadrants.py (which tests/test_torch_cuda.py
and chip_smoke.py run on the card, bit for bit) on the plain forward,
against the JAX package's forward in interpret mode."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from robosimgs_tpu.render.config import RenderConfig as JConfig
from robosimgs_tpu.render.pallas_kernels import composite_fwd_pallas

from robosimgs_tpu_torch.render.binning import bin_and_gather_packed
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.gathered import tile_alpha, tile_pixel_coords
from robosimgs_tpu_torch.render.kernels import (FWD_THREADS, composite_fwd,
                                                footprint_misses, fwd_bands,
                                                fwd_skip_grain,
                                                fwd_skip_groups)
from robosimgs_tpu_torch.render.project import project
from robosimgs_tpu_torch.render.tiles import num_tiles
from robosimgs_tpu_torch.tools.quadrants import (forward_diffs,
                                                 quadrant_blocks,
                                                 quadrant_diffs)
from robosimgs_tpu_torch.tools.workloads import bench_scene, feasibility_scene


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("ts", range(1, 33))
def test_fwd_bands_partition_the_tile(ts):
    """Every pixel in exactly one band, bands of whole rows in rank order,
    none over a block's 256 threads, at most 8 (the portable cluster);
    one band where the tile is whole warps up to 16x16, else
    ceil(P / 256)."""
    bands = fwd_bands(ts)
    P = ts * ts
    owner = np.zeros(P, np.int64)
    for r0, r1 in bands:
        assert 0 <= r0 < r1 <= ts
        assert (r1 - r0) * ts <= FWD_THREADS
        owner[r0 * ts:r1 * ts] += 1
    assert (owner == 1).all()
    assert [b[0] for b in bands] == sorted(b[0] for b in bands)
    assert len(bands) <= 8
    whole = P <= 256 and P % 32 == 0
    assert len(bands) == (1 if whole else -(-P // 256))


@pytest.mark.parametrize("ts", [0, 33])
def test_fwd_bands_refuse_tiles_past_32(ts):
    with pytest.raises(ValueError):
        fwd_bands(ts)


@pytest.mark.parametrize("ts,n_tiles,grain", [
    (16, 4096, None), (8, 10, None), (12, 10, "warp"), (12, 300, "band"),
    (32, 64, "warp"), (32, 96, "band"), (32, 160, "band"), (32, 256, "band"),
    (24, 88, "warp"), (24, 89, "band")])
def test_fwd_skip_grain(ts, n_tiles, grain):
    """Per warp where every block fits the card two a SM (132 SMs), per
    band past that; no skip for whole-warp tiles up to 16x16. The 32-px
    cases are launch sizes tools/fwd_grains.py timed on the 3M view (the
    faster grain there at each); the others follow the rule (not timed)."""
    assert fwd_skip_grain(n_tiles, ts, 132) == grain


def _blocks(ts, tiles_x, tiles_y, n_img=1, K=384, seed=0):
    """Gathered (T, 8, K) blocks for ts-px tiles: splats of sizes 1-6 px
    over each tile and its margin, opacities 0.05-0.99 (every fourth
    one near-opaque, so some pixels saturate), counts K/2..K, depths
    sorted."""
    rng = np.random.default_rng(seed)
    T = tiles_x * tiles_y * n_img
    t_img = np.arange(T) % (tiles_x * tiles_y)
    ox = (t_img % tiles_x) * ts
    oy = (t_img // tiles_x) * ts
    geom = np.zeros((T, 8, K), np.float32)
    geom[:, 0] = ox[:, None] + rng.uniform(-4, ts + 4, (T, K))
    geom[:, 1] = oy[:, None] + rng.uniform(-4, ts + 4, (T, K))
    sx = rng.uniform(1.0, 6.0, (T, K))
    sy = rng.uniform(1.0, 6.0, (T, K))
    rho = rng.uniform(-0.6, 0.6, (T, K))
    cxy = rho * sx * sy
    det = sx * sx * sy * sy - cxy * cxy
    geom[:, 2] = sy * sy / det
    geom[:, 3] = -cxy / det
    geom[:, 4] = sx * sx / det
    geom[:, 5] = rng.uniform(0.05, 0.99, (T, K))
    geom[:, 5, ::4] = 0.99
    geom[:, 6] = np.sort(rng.uniform(1.0, 5.0, (T, K)), axis=1)
    counts = rng.integers(K // 2, K + 1, T).astype(np.int32)
    geom[:, 5][np.arange(K)[None, :] >= counts[:, None]] = 0.0
    feat = rng.uniform(0, 1, (T, 8, K)).astype(np.float32)
    dlim = rng.uniform(2.0, 5.0, (T, ts * ts, 1)).astype(np.float32)
    return geom, feat, counts, dlim


@pytest.mark.parametrize("ts,has_dlim,n_img", [(32, False, 1), (32, True, 1),
                                               (24, False, 1), (32, False, 2)])
def test_quadrant_blocks_cover_each_tile(ts, has_dlim, n_img):
    """The half-size tiles take each tile's pixels at the same
    coordinates; the plain forward on them gives the tile's out, the
    tile's nblk as the largest of its quadrants', and log T where they
    agree (the plain version sums within a block by cumsum, so to f32
    rounding); on 32x32 tiles the JAX package's forward in interpret mode
    gives the tile side the same outputs."""
    tiles_x, tiles_y = 2, 2
    geom, feat, counts, dlim = _blocks(ts, tiles_x, tiles_y, n_img)
    T = geom.shape[0]
    cfg = RenderConfig(tile_size=ts, tile_capacity=geom.shape[2])
    kw = dict(tiles_x=tiles_x, cfg=cfg,
              n_tiles_per_image=T // n_img if n_img > 1 else 0,
              has_dlim=has_dlim)
    args = (torch.from_numpy(geom), torch.from_numpy(feat),
            torch.from_numpy(counts), torch.from_numpy(dlim))
    full = composite_fwd(*args, **kw)
    *half_in, kw_half = quadrant_blocks(*args, **kw)
    assert half_in[0].shape == (4 * T, 8, geom.shape[2])
    assert kw_half["cfg"].tile_size == ts // 2
    # each quadrant tile's pixels are its tile's, coordinate for coordinate
    h = ts // 2
    n_half = 4 * (T // n_img)
    px, py = tile_pixel_coords(torch.arange(4 * T) % n_half, 2 * tiles_x, h)
    fx, fy = tile_pixel_coords(torch.arange(T) % (T // n_img), tiles_x, ts)
    for t in range(T):
        want = set(zip(fx[t].tolist(), fy[t].tolist()))
        got = set()
        for k in range(4 * T):
            if torch.equal(half_in[0][k], args[0][t]):
                got |= set(zip(px[k].tolist(), py[k].tolist()))
        assert got == want
    half = composite_fwd(*half_in, **kw_half)
    d = quadrant_diffs(full, half, **kw)
    assert d["nblk_over"] == 0
    assert int(full[2].max()) > 1 and d["tiles_equal"] > 0
    assert d["out"] <= 1e-6 and d["log_t_final"] <= 1e-5
    assert d["log_t_groups"] <= 1e-5
    if ts == 32 and n_img == 1:
        jcfg = JConfig(tile_size=ts, tile_capacity=geom.shape[2])
        jout, jlt, jnb = composite_fwd_pallas(
            jnp.asarray(geom), jnp.asarray(feat), jnp.asarray(counts),
            jnp.asarray(dlim), tiles_x=tiles_x, cfg=jcfg, has_dlim=has_dlim,
            interpret=True)
        assert np.array_equal(np.asarray(jnb), full[2].numpy())
        np.testing.assert_allclose(np.asarray(jout), full[0].numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(jlt), full[1].numpy(),
                                   atol=1e-4)


def test_quadrant_blocks_need_an_even_tile():
    geom, feat, counts, dlim = _blocks(8, 1, 1)
    cfg = dataclasses.replace(RenderConfig(), tile_size=7)
    with pytest.raises(ValueError):
        quadrant_blocks(torch.from_numpy(geom), torch.from_numpy(feat),
                        torch.from_numpy(counts), None, tiles_x=1, cfg=cfg,
                        has_dlim=False)


def _kept_by_group(geom, tiles_x, cfg, grain, chunk=8):
    """(T, G, K) bool: some pixel of the group (fwd_skip_groups) keeps
    the slot, by render/gathered.py::tile_alpha (every slot in the count,
    no limit)."""
    T, _, K = geom.shape
    groups = fwd_skip_groups(cfg.tile_size, grain)
    t_img = torch.arange(T)
    out = []
    for s in range(0, T, chunk):
        e = min(s + chunk, T)
        px, py = tile_pixel_coords(t_img[s:e], tiles_x, cfg.tile_size)
        kept = tile_alpha(geom[s:e], px, py, torch.ones((e - s, K), dtype=bool),
                          cfg) > 0
        out.append(torch.stack([kept[:, a:b].any(dim=1) for a, b in groups],
                               dim=1))
    return torch.cat(out)


@pytest.mark.parametrize("grain", ["warp", "band"])
@pytest.mark.parametrize("ts", [32, 24, 20, 12])
def test_fwd_skip_groups_cover_the_bands(ts, grain):
    """Each pixel in one group; a warp is 32 consecutive pixels of a band
    (the last of a band may hold fewer); a band group is its band."""
    groups = fwd_skip_groups(ts, grain)
    covered = np.zeros(ts * ts, np.int64)
    for a, b in groups:
        covered[a:b] += 1
    assert (covered == 1).all()
    bands = [(r0 * ts, r1 * ts) for r0, r1 in fwd_bands(ts)]
    if grain == "band":
        assert groups == bands
    else:
        for a, b in groups:
            start = max(s for s, _ in bands if s <= a)
            end = min(e for _, e in bands if e > a)
            assert (a - start) % 32 == 0 and b == min(a + 32, end)


def _conic(sx, sy, rho):
    cxy = rho * sx * sy
    det = sx * sx * sy * sy - cxy * cxy
    return sy * sy / det, -cxy / det, sx * sx / det


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1), ts=st.sampled_from([32, 24, 20, 12]),
       thin=st.booleans(), near=st.floats(0.995, 1.005),
       grain=st.sampled_from(["warp", "band"]))
def test_footprint_never_rejects_a_kept_pair(seed, ts, thin, near, grain):
    """Random splats around one tile, thin conics (axis ratio up to 1e3)
    or round ones, each splat's opacity set so that its largest alpha
    over one random warp's pixels is alpha_min times `near` (0.995-1.005:
    at the 1/255 cutoff), or random: wherever the test skips a slot for a
    warp or a band, no pixel of it keeps the slot by tile_alpha."""
    rng = np.random.default_rng(seed)
    K = 128
    cfg = RenderConfig(tile_size=ts, tile_capacity=K)
    geom = np.zeros((1, 8, K), np.float32)
    geom[0, 0] = rng.uniform(-12, ts + 12, K)
    geom[0, 1] = rng.uniform(-12, ts + 12, K)
    if thin:
        sx = 10.0 ** rng.uniform(-1.0, 1.5, K)
        sy = sx * 10.0 ** rng.uniform(-3.0, 0.0, K)
        rho = rng.uniform(-0.999, 0.999, K)
    else:
        sx = rng.uniform(0.5, 8.0, K)
        sy = rng.uniform(0.5, 8.0, K)
        rho = rng.uniform(-0.5, 0.5, K)
    geom[0, 2], geom[0, 3], geom[0, 4] = _conic(sx, sy, rho)
    geom[0, 5] = rng.uniform(0.0, 1.0, K)
    g = torch.from_numpy(geom)
    warps = fwd_skip_groups(ts, "warp")
    a, b = warps[rng.integers(len(warps))]
    px, py = tile_pixel_coords(torch.zeros(1, dtype=torch.long), 1, ts)
    # q at the chosen warp's pixels, in float64: the least one sets op
    dx = px[0, a:b, None].double() - g[0, 0].double()
    dy = py[0, a:b, None].double() - g[0, 1].double()
    q = (0.5 * (g[0, 2].double() * dx * dx + g[0, 4].double() * dy * dy)
         + g[0, 3].double() * dx * dy).amin(dim=0)
    at_cut = (q < 40).numpy() & (rng.uniform(size=K) < 0.7)
    geom[0, 5, at_cut] = np.minimum(
        cfg.alpha_min * np.exp(q.numpy()[at_cut]) * near, 0.99)
    g = torch.from_numpy(geom)
    misses = footprint_misses(g, tiles_x=1, cfg=cfg, grain=grain)
    kept = _kept_by_group(g, 1, cfg, grain)
    assert not bool((misses & kept).any())


@pytest.mark.parametrize("grain", ["warp", "band"])
@pytest.mark.parametrize("scene", ["bench", "feasibility"])
def test_footprint_never_rejects_a_kept_pair_on_binned_blocks(scene, grain):
    """Binned 32x32 blocks of the bench scene's draw (3,000 of its 100k
    Gaussians, 256x256) and the feasibility scene's (30,000 of 3M,
    512x512, on its first 64 tiles): the test skips no slot that a pixel
    of the warp or band keeps, and skips a good share of the rest."""
    make = bench_scene if scene == "bench" else feasibility_scene
    g, cam, _ = make("cpu", n=3000 if scene == "bench" else 30000)
    cfg = RenderConfig(tile_size=32, tile_capacity=2048)
    tiles_x = num_tiles(cam.width, cam.height, 32)[0]
    with torch.no_grad():
        geom, _, counts, _ = bin_and_gather_packed(
            project(g, cam, cfg), cam.width, cam.height, cfg)
    geom, counts = geom[:64], counts[:64]
    misses = footprint_misses(geom, tiles_x=tiles_x, cfg=cfg, grain=grain)
    kept = _kept_by_group(geom, tiles_x, cfg, grain)
    assert not bool((misses & kept).any())
    in_count = (torch.arange(geom.shape[2])[None, :] < counts[:, None])
    share = float(misses[in_count[:, None, :].expand_as(misses)].float()
                  .mean())
    assert 0.1 < share < 1.0


@pytest.mark.parametrize("ts,skip", [(16, "warp"), (16, "band"), (8, "warp"),
                                     (32, "diagonal"), (12, "all")])
def test_composite_fwd_refuses_a_skip_it_has_not(ts, skip):
    """Whole-warp tiles up to 16x16 run one block a tile, which walks every
    slot: only "none" (or None); other names are refused on any tile."""
    geom, feat, counts, _ = (torch.from_numpy(x) for x in _blocks(ts, 1, 1))
    cfg = RenderConfig(tile_size=ts, tile_capacity=384)
    with pytest.raises(ValueError, match="skip"):
        composite_fwd(geom, feat, counts, None, tiles_x=1, cfg=cfg,
                      has_dlim=False, skip=skip)


@pytest.mark.parametrize("ts", [16, 32])
def test_composite_fwd_skip_none_is_the_plain_forward_on_cpu(ts):
    """On CPU tensors every skip runs the plain version, the same bits."""
    geom, feat, counts, _ = (torch.from_numpy(x) for x in _blocks(ts, 2, 1))
    cfg = RenderConfig(tile_size=ts, tile_capacity=384)
    kw = dict(tiles_x=2, cfg=cfg, has_dlim=False)
    base = composite_fwd(geom, feat, counts, None, **kw)
    for skip in ["none"] + (["warp", "band"] if ts == 32 else []):
        got = composite_fwd(geom, feat, counts, None, **kw, skip=skip)
        assert all(v == 0.0 for v in forward_diffs(got, base).values())


@pytest.mark.parametrize("ts,pairs", [
    (32, torch.zeros(2, dtype=torch.int64)),
    (32, torch.zeros(3, dtype=torch.int64)),
    (32, torch.zeros(2, dtype=torch.int32)),
    (16, torch.zeros(2, dtype=torch.int64))])
def test_composite_fwd_counts_pairs_only_on_the_card(ts, pairs):
    """The pair counter is the cluster instance's: a CPU call, a counter
    of another shape or type, or whole-warp tiles up to 16x16 (one block
    a tile) are refused."""
    geom, feat, counts, _ = (torch.from_numpy(x) for x in _blocks(ts, 1, 1))
    cfg = RenderConfig(tile_size=ts, tile_capacity=384)
    with pytest.raises(ValueError, match="pairs"):
        composite_fwd(geom, feat, counts, None, tiles_x=1, cfg=cfg,
                      has_dlim=False, pairs=pairs)


def test_forward_diffs_read_only_the_processed_groups():
    """forward_diffs sees a difference in out, log_t_final, nblk and in
    log_t_groups of the processed batches, and none past them (never
    written)."""
    geom, feat, counts, _ = (torch.from_numpy(x) for x in _blocks(32, 2, 1))
    cfg = RenderConfig(tile_size=32, tile_capacity=384)
    a = composite_fwd(geom, feat, counts, None, tiles_x=2, cfg=cfg,
                      has_dlim=False)
    b = tuple(x.clone() for x in a)
    for t, n in enumerate(a[2].tolist()):
        b[3][t, n * (128 // 16):] = float("nan")
    assert all(v == 0.0 for v in forward_diffs(a, b).values())
    for i, key in enumerate(["out", "log_t_final", "nblk", "log_t_groups"]):
        c = [x.clone() for x in a]
        c[i].view(-1)[0] += 1
        assert forward_diffs(a, tuple(c))[key] == 1.0
