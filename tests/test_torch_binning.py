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
