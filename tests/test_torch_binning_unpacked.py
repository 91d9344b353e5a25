"""The unpacked binner's parity: the port's bin_gaussians and
gather_tile_features against the JAX package's on the SAME projected
splats (taken from JAX as numpy), on the scenes of the JAX package's
tests/test_tiled.py, and a render through composite_from_tiles against
the Pallas forward run in interpret mode.

Tolerances: sel, counts and BinStats integer-equal; geom and feat
bit-equal; gradients through the takes within 1e-5 of the field's
largest entry (both sides scatter-add the same terms, in another order);
the render within 1e-5 (tests/test_tiled.py's tolerance for the Pallas
kernel against its oracle)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosimgs_tpu.core.camera import Camera as JCamera
from robosimgs_tpu.core.types import Gaussians as JGaussians
from robosimgs_tpu.render import binning as jbinning
from robosimgs_tpu.render.config import RenderConfig as JConfig
from robosimgs_tpu.render.project import project as jproject
from robosimgs_tpu.render.tiled import \
    composite_from_tiles as jcomposite_from_tiles

from robosimgs_tpu_torch.core.convert import projected_from_numpy
from robosimgs_tpu_torch.render.binning import (bin_and_gather_packed,
                                                bin_gaussians,
                                                gather_tile_features)
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.tiled import composite_from_tiles

# tests/test_tiled.py's config and scenes: (width, height, n, seed, cfg)
CFG = dict(tile_capacity=256, max_tiles_per_gaussian=64,
           ref_gaussian_chunk=64)
SCENES = {
    "covers_all_pairs": (64, 48, 100, 2, CFG),
    "capacity_4": (16, 16, 50, 1, dict(tile_capacity=4,
                                       max_tiles_per_gaussian=64)),
    "fwd_oracle": (64, 48, 150, 4, CFG),
    "bwd_autodiff": (48, 32, 80, 5, CFG),
}
FIELDS = ("means2d", "conics", "opacities", "colors", "depths", "normals",
          "abs_probe")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_proj(name, normals=False, probe=False):
    w, h, n, seed, kw = SCENES[name]
    cfg = JConfig(**kw, render_normals=normals)
    g = JGaussians.random(jax.random.PRNGKey(seed), n, sh_degree=1)
    cam = JCamera.look_at([4.0, 0.3, 0.8], [0, 0, 0], [0, 0, 1], 60.0, w, h)
    proj = jproject(g, cam, cfg,
                    abs_probe=jnp.zeros((n, 2)) if probe else None)
    return proj, w, h, cfg


def _port_cfg(cfg: JConfig) -> RenderConfig:
    return RenderConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", list(SCENES))
def test_bin_gaussians_matches_jax(name):
    jproj, w, h, jcfg = _jax_proj(name)
    jsel, jcounts, jstats = jax.device_get(
        jax.jit(lambda p: jbinning.bin_gaussians(p, w, h, jcfg))(jproj))
    proj = projected_from_numpy(jax.device_get(jproj), "cpu")
    sel, counts, stats = bin_gaussians(proj, w, h, _port_cfg(jcfg))
    for f in dataclasses.fields(jstats):
        assert int(getattr(stats, f.name)) == int(getattr(jstats, f.name)), \
            f.name
    if name == "capacity_4":
        assert int(stats.overflowed_tiles) > 0, "capacity 4 does not overflow"
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), jcounts)
    np.testing.assert_array_equal(sel.numpy(), jsel)


@pytest.mark.parametrize("normals,probe", [(False, False), (True, False),
                                           (True, True), (False, True)],
                         ids=["plain", "normals", "normals_probe", "probe"])
def test_gather_tile_features_matches_jax(normals, probe):
    jproj, w, h, jcfg = _jax_proj("fwd_oracle", normals, probe)
    jsel, jcounts, _ = jbinning.bin_gaussians(jproj, w, h, jcfg)
    jgeom, jfeat = jax.device_get(
        jbinning.gather_tile_features(jproj, jsel, jcounts, jcfg))
    proj = projected_from_numpy(jax.device_get(jproj), "cpu")
    sel, counts, _ = bin_gaussians(proj, w, h, _port_cfg(jcfg))
    geom, feat = gather_tile_features(proj, sel, counts, _port_cfg(jcfg))
    assert geom.is_contiguous() and feat.is_contiguous()
    np.testing.assert_array_equal(geom.numpy(), jgeom)
    np.testing.assert_array_equal(feat.numpy(), jfeat)
    if normals and not probe:
        assert np.abs(jfeat[:, 7]).max() > 0.0, "row 7 carries no nz"


@pytest.mark.parametrize("normals", [False, True], ids=["plain", "normals"])
def test_gather_tile_features_gradients_match_jax_vjp(normals):
    jproj, w, h, jcfg = _jax_proj("bwd_autodiff", normals)
    jsel, jcounts, _ = jbinning.bin_gaussians(jproj, w, h, jcfg)
    T, K = jsel.shape
    rng = np.random.default_rng(0)
    ct_geom = rng.standard_normal((T, 8, K)).astype(np.float32)
    ct_feat = rng.standard_normal((T, 8, K)).astype(np.float32)
    names = [f for f in FIELDS if getattr(jproj, f) is not None]

    def f(*vals):
        p = dataclasses.replace(jproj, **dict(zip(names, vals)))
        return jbinning.gather_tile_features(p, jsel, jcounts, jcfg)

    _, vjp = jax.vjp(f, *[getattr(jproj, k) for k in names])
    want = dict(zip(names, jax.device_get(vjp((jnp.asarray(ct_geom),
                                               jnp.asarray(ct_feat))))))

    proj = projected_from_numpy(jax.device_get(jproj), "cpu")
    leaves = {k: getattr(proj, k).requires_grad_() for k in names}
    proj = dataclasses.replace(proj, **leaves)
    sel, counts, _ = bin_gaussians(proj, w, h, _port_cfg(jcfg))
    geom, feat = gather_tile_features(proj, sel, counts, _port_cfg(jcfg))
    torch.autograd.backward([geom, feat], [torch.from_numpy(ct_geom),
                                           torch.from_numpy(ct_feat)])
    for k in names:
        scale = float(np.abs(want[k]).max())
        assert scale > 0.0, k
        np.testing.assert_allclose(leaves[k].grad.numpy(), want[k], rtol=0,
                                   atol=1e-5 * scale, err_msg=k)


def test_unpacked_render_matches_pallas_interpret():
    jproj, w, h, jcfg = _jax_proj("fwd_oracle")
    jsel, jcounts, _ = jbinning.bin_gaussians(jproj, w, h, jcfg)
    jgeom, jfeat = jbinning.gather_tile_features(jproj, jsel, jcounts, jcfg)
    want = jax.device_get(jcomposite_from_tiles(
        jgeom, jfeat, jcounts, w, h, jcfg, compositor="pallas"))
    proj = projected_from_numpy(jax.device_get(jproj), "cpu")
    cfg = _port_cfg(jcfg)
    sel, counts, _ = bin_gaussians(proj, w, h, cfg)
    geom, feat = gather_tile_features(proj, sel, counts, cfg)
    got = composite_from_tiles(geom, feat, counts, w, h, cfg)
    assert float(want["alpha"].max()) > 0.5, "empty render"
    for k in ("rgb", "alpha", "depth"):
        np.testing.assert_allclose(got[k].detach().numpy(), want[k],
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def test_unpacked_equals_packed_without_the_cull():
    """With exact_tile_cull off and one tier, the unpacked and the packed
    binners select the same splats and gather the same rows (what
    chip_smoke phase 14a holds on the card at the bench width)."""
    jproj, w, h, jcfg = _jax_proj("fwd_oracle")
    cfg = dataclasses.replace(_port_cfg(jcfg), exact_tile_cull=False)
    proj = projected_from_numpy(jax.device_get(jproj), "cpu")
    sel, counts, stats = bin_gaussians(proj, w, h, cfg)
    geom, feat = gather_tile_features(proj, sel, counts, cfg)
    pgeom, pfeat, pcounts, pstats, psel = bin_and_gather_packed(
        proj, w, h, cfg, return_sel=True)
    assert torch.equal(counts, pcounts)
    live = torch.arange(sel.shape[1])[None, :] < counts[:, None]
    assert torch.equal(sel[live], psel[live])
    assert torch.equal(geom.transpose(1, 2)[live], pgeom.transpose(1, 2)[live])
    assert torch.equal(feat.transpose(1, 2)[live], pfeat.transpose(1, 2)[live])
    for f in dataclasses.fields(stats):
        assert int(getattr(stats, f.name)) == int(getattr(pstats, f.name))


def test_unpacked_gradients_equal_packed_through_composite():
    """One Composite backward through each route (the plain versions on
    the CPU): the per-Gaussian gradients agree within 1e-5 of the largest
    (chip_smoke phase 14a's gate on the card)."""
    from robosimgs_tpu_torch.render.tiled import composite_tiled
    jproj, w, h, jcfg = _jax_proj("fwd_oracle")
    cfg = dataclasses.replace(_port_cfg(jcfg), exact_tile_cull=False)
    base = projected_from_numpy(jax.device_get(jproj), "cpu")
    target = torch.full((h, w, 3), 0.3)
    grads = {}
    for route in ("unpacked", "packed"):
        leaves = {k: getattr(base, k).clone().requires_grad_()
                  for k in ("means2d", "conics", "opacities", "colors",
                            "depths")}
        proj = dataclasses.replace(base, **leaves)
        if route == "unpacked":
            sel, counts, _ = bin_gaussians(proj, w, h, cfg)
            geom, feat = gather_tile_features(proj, sel, counts, cfg)
            rgb = composite_from_tiles(geom, feat, counts, w, h, cfg)["rgb"]
        else:
            rgb = composite_tiled(proj, w, h, cfg)["rgb"]
        ((rgb - target) ** 2).sum().backward()
        grads[route] = {k: v.grad for k, v in leaves.items()}
    scale = max(float(v.abs().max()) for v in grads["packed"].values())
    assert scale > 0.0
    for k, want in grads["packed"].items():
        np.testing.assert_allclose(grads["unpacked"][k].numpy(),
                                   want.numpy(), rtol=0, atol=1e-5 * scale,
                                   err_msg=k)
