"""Tile binning parity: the port's bin_and_gather_packed against the JAX
package's on the SAME projected splats (taken from JAX as numpy)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from robosimgs_tpu.core.camera import Camera as JCamera
from robosimgs_tpu.core.types import Gaussians as JGaussians
from robosimgs_tpu.render import binning as jbinning
from robosimgs_tpu.render.config import RenderConfig as JConfig
from robosimgs_tpu.render.project import project as jproject

from cull_cases import cull_inputs, row_sort_path
from robosimgs_tpu_torch.core.convert import projected_from_numpy
from robosimgs_tpu_torch.render.binning import bin_and_gather_packed
from robosimgs_tpu_torch.render.config import RenderConfig

W, H = 64, 48

CONFIGS = {
    "default": dict(tile_capacity=256),
    # the bench config (bench.py): survivor compaction + two-tier sort
    "bench": dict(tile_capacity=384, max_tiles_per_gaussian=10,
                  bbox_tiles_per_gaussian=12, two_tier_split=4,
                  two_tier_spill_frac=0.15),
    # capacity overflow: tiles keep their closest K entries
    "overflow": dict(tile_capacity=8, max_tiles_per_gaussian=16),
    # under-provisioned spill tier: dropped pairs counted in BinStats
    "spill": dict(tile_capacity=128, max_tiles_per_gaussian=16,
                  two_tier_split=1, two_tier_spill_frac=0.0),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_proj(scale=None):
    g = JGaussians.random(jax.random.PRNGKey(3), 200, sh_degree=1,
                          capacity=208)
    if scale is not None:   # wide splats: most cover several tiles
        g = g.replace(log_scales=g.log_scales * 0 + np.log(scale))
    cam = JCamera.look_at([3.0, 0.5, 1.0], [0, 0, 0], [0, 0, 1], 55.0, W, H)
    return jproject(g, cam, JConfig())


@pytest.fixture(scope="module")
def jax_proj():
    return _jax_proj()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bin_and_gather_packed_matches_jax(jax_proj, name):
    kw = CONFIGS[name]
    if name == "spill":
        jax_proj = _jax_proj(scale=0.1)
    jgeom, jfeat, jcounts, jstats, jsel = jax.device_get(
        jbinning.bin_and_gather_packed(jax_proj, W, H, JConfig(**kw),
                                       return_sel=True))
    proj = projected_from_numpy(jax.device_get(jax_proj), "cpu")
    geom, feat, counts, stats, sel = bin_and_gather_packed(
        proj, W, H, RenderConfig(**kw), return_sel=True)

    for f in dataclasses.fields(jstats):
        assert int(getattr(stats, f.name)) == int(getattr(jstats, f.name)), f.name
    if name == "overflow":
        assert int(stats.overflowed_tiles) > 0, "scene does not overflow"
    if name == "spill":
        assert int(stats.truncated_gaussians) > 0, "spill tier not exceeded"
    np.testing.assert_array_equal(counts.numpy(), jcounts)
    kmask = np.arange(jsel.shape[1])[None, :] < jcounts[:, None]
    np.testing.assert_array_equal(sel.numpy()[kmask], jsel[kmask])
    np.testing.assert_array_equal(geom.numpy(), jgeom)
    np.testing.assert_array_equal(feat.numpy(), jfeat)
    assert geom.is_contiguous() and feat.is_contiguous()
    assert counts.dtype == torch.int32


def test_cull_keep_matches_jax(jax_proj):
    """The exact ellipse-tile cull on every candidate tile of the bbox."""
    p = jax.device_get(jax_proj)
    n, M = p.means2d.shape[0], 12
    rng = np.random.default_rng(0)
    tx0 = rng.integers(0, 4, n).astype(np.int32)
    ty0 = rng.integers(0, 3, n).astype(np.int32)
    col = rng.integers(0, 3, (n, M)).astype(np.int32)
    row = rng.integers(0, 3, (n, M)).astype(np.int32)
    cop = np.concatenate([p.conics, p.opacities[:, None]], 1)
    want = np.asarray(jbinning._cull_keep(p.means2d, cop, tx0, ty0, col, row,
                                          16, 1.0 / 255.0))
    from robosimgs_tpu_torch.render.binning import _cull_keep
    t = torch.from_numpy
    got = _cull_keep(t(np.array(p.means2d)), t(cop), t(tx0).long(),
                     t(ty0).long(), t(col).long(), t(row).long(), 16,
                     1.0 / 255.0)
    assert 0 < want.sum() < want.size, "cull decides nothing"
    np.testing.assert_array_equal(got.numpy(), want)


# the tiled compositor needs K in whole 128-splat batches; wide splats
# ("wide") overflow K = 128 and truncate at M = 3
SEGMENT_CASES = {
    "default": (dict(tile_capacity=256), False),
    "bench": (CONFIGS["bench"], False),
    "overflow": (dict(tile_capacity=128, max_tiles_per_gaussian=16), True),
    "spill": (CONFIGS["spill"], True),
    "bbox": (dict(tile_capacity=128, max_tiles_per_gaussian=3,
                  bbox_tiles_per_gaussian=12), True),
}


def autograd_gather(packed, sel, order, pos):
    """_GatherRows.apply as autograd's own gather: its transpose is
    index_put_ with accumulate over every (tile, slot), padding too."""
    return packed[sel]


@pytest.mark.parametrize("name", list(SEGMENT_CASES))
def test_segment_transpose_keeps_the_gradient_bits(name, monkeypatch):
    """The gather's gradient as each Gaussian's sum over its kept
    entries (binning._GatherRows) gives every parameter's gradient,
    through the tiled compositor's plain backward, the same bits as
    autograd's transpose of packed[sel], with truncated splats,
    overflowed tiles and a spill tier."""
    from robosimgs_tpu_torch.core.camera import Camera
    from robosimgs_tpu_torch.core.types import Gaussians
    from robosimgs_tpu_torch.render import binning
    from robosimgs_tpu_torch.render.project import project
    from robosimgs_tpu_torch.render.tiled import composite_tiled
    kw, wide = SEGMENT_CASES[name]
    cfg = RenderConfig(**kw)
    g = Gaussians.random(torch.Generator().manual_seed(4), 400, sh_degree=1,
                         capacity=408, device="cpu")
    if wide:
        g = g.replace(log_scales=torch.full_like(g.log_scales, np.log(0.1)))
    cam = Camera.look_at([3.0, 0.5, 1.0], [0, 0, 0], [0, 0, 1], 55.0, W, H,
                         device="cpu")
    w = torch.randn((H, W, 3), generator=torch.Generator().manual_seed(5))
    fields = ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
              "sh_rest")
    grads = []
    for reference in (True, False):
        with monkeypatch.context() as mp:
            if reference:
                mp.setattr(binning._GatherRows, "apply", autograd_gather)
            params = {k: getattr(g, k).clone().requires_grad_(True)
                      for k in fields}
            out = composite_tiled(project(g.replace(**params), cam, cfg),
                                  W, H, cfg, return_stats=True)
            grads.append(torch.autograd.grad((out["rgb"] * w).sum(),
                                             list(params.values())))
        st = out["stats"]
    if name == "overflow":
        assert int(st.overflowed_tiles) > 0
    if name in ("spill", "bbox"):
        assert int(st.truncated_gaussians) > 0
    for k, a, b in zip(fields, *grads):
        assert torch.equal(a, b), k
        assert bool((a != 0).any()), k


# the fused cull and compaction (render/cull.py): its plain version
# against the enumerate / cull / row-sort path it replaces

@pytest.mark.parametrize("Mb,M,exact", [(24, 12, True), (16, 16, True),
                                        (24, 12, False)],
                         ids=["Mb>M", "Mb=M", "cull-off"])
def test_cull_compact_plain_matches_the_row_sort_path(Mb, M, exact):
    from robosimgs_tpu_torch.render.cull import bin_cull_compact
    from robosimgs_tpu_torch.render.tiles import cull_qcut
    bbox, edges, tiles_x, T = cull_inputs(seed=Mb + M)
    qcut = cull_qcut(bbox[:, 6], 1.0 / 255.0) if exact else None
    tid, surv, cover = bin_cull_compact(
        bbox, qcut, *edges, tiles_x=tiles_x, n_tiles=T, n_slots=Mb,
        max_tiles=M, tile_size=16)
    want = row_sort_path(bbox, edges, tiles_x, T, Mb, M, exact)
    for got, w in zip((tid, surv, cover), want):
        assert got.dtype == torch.int64 and torch.equal(got, w)
    assert tid.shape == (bbox.shape[0], M)
    # every row: its kept tiles in enumeration order, then the sentinel
    full, _, _ = row_sort_path(bbox, edges, tiles_x, T, Mb, Mb, exact,
                                sort=False)
    for i in range(0, bbox.shape[0], 7):
        kept = full[i][full[i] < T][:M]
        assert torch.equal(tid[i, :len(kept)], kept)
        assert bool((tid[i, len(kept):] == T).all())
    # the draw reaches every case the kernel has to get right
    valid = bbox[:, 2] > 0
    assert bool((cover[valid] > Mb).any())
    assert bool((surv > M).any()) if Mb > M else bool((surv == M).any())
    assert bool((surv[~valid] == 0).all()) and not bool(valid.all())
    left, right = edges[0] == 0, edges[2] == tiles_x - 1
    assert bool((valid & left).any()) and bool((valid & right).any())
    if exact:
        nopsd = valid & ~((bbox[:, 3] > 0) & (bbox[:, 5] > 0))
        assert bool(nopsd.any())
        assert bool((surv[nopsd] == torch.clamp_max(cover[nopsd], Mb)).all())
        assert bool((surv[valid] < torch.clamp_max(cover[valid], Mb)).any())
    else:
        assert torch.equal(surv, torch.where(valid, cover.clamp_max(Mb), 0))


# binning's capacities: the bbox enumerated past M or not, one or two
# tiers (wide splats: some truncate)
COMPACT_CASES = {
    "Mb>M one-tier": dict(max_tiles_per_gaussian=6,
                          bbox_tiles_per_gaussian=12),
    "Mb>M two-tier": dict(max_tiles_per_gaussian=6,
                          bbox_tiles_per_gaussian=12, two_tier_split=2,
                          two_tier_spill_frac=0.2),
    "Mb=M one-tier": dict(max_tiles_per_gaussian=8),
    "Mb=M two-tier": dict(max_tiles_per_gaussian=8, two_tier_split=3,
                          two_tier_spill_frac=0.2),
}


@pytest.mark.parametrize("name", list(COMPACT_CASES))
def test_compaction_keeps_every_output_and_gradient_bit(name, monkeypatch):
    """bin_and_gather_packed through the fused cull and compaction against
    the path it replaces (row sort where Mb > M or two tiers, holes left
    where Mb = M in one tier): the blocks, counts, stats, selection and
    every parameter's gradient through _GatherRows are the same bits. In
    the one-tier Mb = M case compaction moves only the sentinels: the
    sorted real keys are the same."""
    from robosimgs_tpu_torch.core.camera import Camera
    from robosimgs_tpu_torch.core.types import Gaussians
    from robosimgs_tpu_torch.render import binning
    from robosimgs_tpu_torch.render.project import project
    from robosimgs_tpu_torch.render.tiled import composite_tiled
    cfg = RenderConfig(tile_capacity=128, **COMPACT_CASES[name])
    two_tier = 0 < cfg.two_tier_split < cfg.max_tiles_per_gaussian
    g = Gaussians.random(torch.Generator().manual_seed(6), 400, sh_degree=1,
                         capacity=408, device="cpu")
    g = g.replace(log_scales=g.log_scales + 1.5)
    cam = Camera.look_at([3.0, 0.5, 1.0], [0, 0, 0], [0, 0, 1], 55.0, W, H,
                         device="cpu")
    w = torch.randn((H, W, 3), generator=torch.Generator().manual_seed(7))
    fields = ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
              "sh_rest")
    tids = []

    def replaced(bbox, qcut, *edges, tiles_x, n_tiles, n_slots, max_tiles,
                 tile_size):
        out = row_sort_path(bbox, edges, tiles_x, n_tiles, n_slots,
                             max_tiles, qcut is not None, tile_size,
                             cfg.alpha_min,
                             sort=n_slots > max_tiles or two_tier)
        tids.append(out[0])
        return out

    original = binning.bin_cull_compact

    def fused(*args, **kw):
        out = original(*args, **kw)
        tids.append(out[0])
        return out

    runs = []
    for path in (replaced, fused):
        with monkeypatch.context() as mp:
            mp.setattr(binning, "bin_cull_compact", path)
            params = {k: getattr(g, k).clone().requires_grad_(True)
                      for k in fields}
            proj = project(g.replace(**params), cam, cfg)
            with torch.no_grad():
                blocks = bin_and_gather_packed(proj, W, H, cfg,
                                               return_sel=True)
            out = composite_tiled(proj, W, H, cfg, return_stats=True)
            grads = torch.autograd.grad((out["rgb"] * w).sum(),
                                        list(params.values()))
        runs.append((blocks, out["rgb"], grads))
    (b0, rgb0, g0), (b1, rgb1, g1) = runs
    geom, feat, counts, stats, sel = b1
    for a, b in zip((geom, feat, counts), b0[:3]):
        assert torch.equal(a, b)
    for f in dataclasses.fields(stats):
        assert torch.equal(getattr(stats, f.name), getattr(b0[3], f.name))
    kmask = torch.arange(sel.shape[1])[None, :] < counts[:, None].long()
    assert torch.equal(sel[kmask], b0[4][kmask])
    assert torch.equal(rgb0, rgb1)
    for k, a, b in zip(fields, g0, g1):
        assert torch.equal(a, b), k
        assert bool((a != 0).any()), k
    assert int(stats.truncated_gaussians) > 0
    # the keys each path sorted: the same real ones, in the same order
    T = counts.shape[0]
    n = tids[0].shape[0]
    bits = max(1, (n - 1).bit_length())
    assert len(tids) == 4       # each path binned twice
    tid_old, tid_new = tids[0], tids[2]
    keys = [torch.sort(((t << bits) | torch.arange(n)[:, None]).reshape(-1))
            .values for t in (tid_old, tid_new)]
    real = [k[k < (T << bits)] for k in keys]
    assert torch.equal(real[0], real[1]) and real[0].numel() > 0
    if name == "Mb=M one-tier":
        assert not torch.equal(tid_old, tid_new), "no holes to compact"
        assert torch.equal(keys[0], keys[1])
    else:
        assert torch.equal(tid_old, tid_new)
