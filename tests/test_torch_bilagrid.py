"""The bilateral grid (train/bilagrid.py) against the JAX package's: the
four JAX bilagrid tests ported to the port, values and gradients against
JAX on the same numpy inputs, and the tie rule on black pixels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robosimgs_tpu.train.bilagrid as jbg
import robosimgs_tpu_torch.train.bilagrid as bg
from robosimgs_tpu_torch.train.losses import absolute, maximum, minimum
from robosimgs_tpu_torch.core.types import Gaussians
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.rasterize import rasterize
from robosimgs_tpu_torch.train.data import synthetic_scene
from robosimgs_tpu_torch.train.trainer import TrainConfig, Trainer


def _grid(rng, shape=(5, 4, 3), scale=0.1):
    return (np.asarray(jbg.identity_bilagrid(1, shape)[0])
            + rng.normal(scale=scale, size=shape + (12,)).astype(np.float32))


def _weights(shape):
    return np.cos(np.arange(np.prod(shape), dtype=np.float32)
                  ).reshape(shape).astype(np.float32)


def test_bilagrid_identity_and_tv():
    """Identity grids are a colour no-op with zero TV; a perturbed grid
    has positive TV (test_train.py::test_bilagrid_identity_and_tv)."""
    g = bg.identity_bilagrid(2, (4, 4, 3), device="cpu")
    rgb = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (24, 32, 3)).astype(np.float32))
    out = bg.apply_bilagrid(g[0], rgb)
    np.testing.assert_allclose(out.numpy(), rgb.numpy(), atol=1e-5,
                               rtol=1e-5)
    assert float(bg.tv_loss(g)) == 0.0
    g2 = g.clone()
    g2[0, 0, 0, 0, 0] += 0.5
    assert float(bg.tv_loss(g2)) > 0.0


def test_bilagrid_spatial_weights_partition_unity():
    sw = bg._spatial_weights(torch.arange(24), 24, 32, 4, 5)
    np.testing.assert_allclose(sw.sum(-1).numpy(), 1.0, atol=1e-5)


def test_bilagrid_chunked_matches_single_block(monkeypatch):
    """The row-blocked evaluation (70 rows in 5 blocks of 16, the last
    zero-padded) equals the single block on values (rtol 1e-5) and grid
    gradients (1e-4), JAX's own tolerances for the same pair."""
    rng = np.random.default_rng(7)
    grid0 = _grid(rng)
    rgb = torch.from_numpy(rng.uniform(0, 1, (70, 40, 3)).astype(np.float32))
    wts = torch.from_numpy(_weights((70, 40, 3)))

    def total(chunk):
        monkeypatch.setattr(bg, "_CHUNK_PIXELS", chunk)
        grid = torch.from_numpy(grid0).requires_grad_(True)
        t = torch.sum(bg.apply_bilagrid(grid, rgb) * wts)
        t.backward()
        return float(t.detach()), grid.grad.numpy()

    out_c, g_c = total(40 * 16)
    out_d, g_d = total(1 << 20)
    np.testing.assert_allclose(out_c, out_d, rtol=1e-5)
    np.testing.assert_allclose(g_c, g_d, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("h,w,chunk", [(24, 32, 1 << 16), (70, 40, 40 * 16)],
                         ids=["one_block", "five_blocks"])
def test_apply_bilagrid_and_tv_match_jax(monkeypatch, h, w, chunk):
    """Values, and the gradients w.r.t. the grid and the image, against
    JAX on the same inputs, one block and blocked (the JAX side blocked
    alike). Values within 1e-5 relative + 1e-6 (the (P, gh*gw) matmul
    sums in another order); gradients within 1e-4 of the largest."""
    rng = np.random.default_rng(3)
    grid0 = _grid(rng)
    rgb0 = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    wts = _weights((h, w, 3))
    monkeypatch.setattr(jbg, "_CHUNK_PIXELS", chunk)
    monkeypatch.setattr(bg, "_CHUNK_PIXELS", chunk)

    def jtotal(grid, rgb):
        return jnp.sum(jbg.apply_bilagrid(grid, rgb) * wts) \
            + jbg.tv_loss(grid)

    jval = jax.jit(jtotal)(grid0, rgb0)
    jg_grid, jg_rgb = jax.jit(jax.grad(jtotal, argnums=(0, 1)))(grid0, rgb0)
    grid = torch.from_numpy(grid0).requires_grad_(True)
    rgb = torch.from_numpy(rgb0).requires_grad_(True)
    out = bg.apply_bilagrid(grid, rgb)
    np.testing.assert_allclose(
        out.detach().numpy(), np.asarray(jbg.apply_bilagrid(grid0, rgb0)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(bg.tv_loss(grid.detach())),
                               float(jbg.tv_loss(grid0)), rtol=1e-5)
    val = torch.sum(out * torch.from_numpy(wts)) + bg.tv_loss(grid)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    for got, want in ((grid.grad, jg_grid), (rgb.grad, jg_rgb)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_tie_gradients_match_jax_on_black_pixels():
    """A black image (every pixel ties the exposure clip, the gray clip
    and the hat weights at gray 0) and gray values exactly on grid
    levels: the gradients w.r.t. the image and the grid equal JAX's,
    whose maximum and minimum split the gradient at a tie and whose |x|
    has slope 1 at 0. torch.clamp and torch.abs would give 1 and 0
    there."""
    rng = np.random.default_rng(5)
    grid0 = _grid(rng, (4, 4, 3), scale=0.05)
    rgb0 = np.zeros((16, 12, 3), np.float32)
    rgb0[:4] = 0.5          # gray 0.5 = level 1 of 3: a tie in the hat
    rgb0[4:6] = 1.0         # gray 1: the top clip ties
    wts = _weights(rgb0.shape)

    def jtotal(grid, rgb):
        return jnp.sum(jbg.apply_bilagrid(grid, rgb) * wts)

    jg_grid, jg_rgb = jax.grad(jtotal, argnums=(0, 1))(grid0, rgb0)
    grid = torch.from_numpy(grid0).requires_grad_(True)
    rgb = torch.from_numpy(rgb0).requires_grad_(True)
    torch.sum(bg.apply_bilagrid(grid, rgb) * torch.from_numpy(wts)).backward()
    for got, want in ((grid.grad, jg_grid), (rgb.grad, jg_rgb)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    # the helpers themselves, at their ties
    x = torch.zeros(3, requires_grad=True)
    (maximum(x, 0.0).sum() + minimum(x, 0.0).sum()
     + absolute(x).sum()).backward()
    np.testing.assert_array_equal(x.grad.numpy(), [2.0, 2.0, 2.0])


def test_bilagrid_corrects_vignette():
    """The port's test_train.py::test_bilagrid_corrects_vignette: targets
    with a radial vignette; the bilateral grid's post-correction training
    PSNR beats no correction by 1 dB and a per-frame affine by 0.5 dB."""
    rcfg = RenderConfig(ref_gaussian_chunk=64, tile_capacity=128)
    gt, frames = synthetic_scene(2, 40, 4, 48, 48, sh_degree=1, device="cpu")
    yy, xx = np.mgrid[0:48, 0:48].astype(np.float32)
    r2 = ((yy - 23.5) ** 2 + (xx - 23.5) ** 2) / (23.5 ** 2)
    vignette = (1.0 - 0.55 * np.clip(r2, 0, 1))[:, :, None]
    with torch.no_grad():
        for f in frames:
            clean = rasterize(gt, f.camera, rcfg, impl="reference")["rgb"]
            f.image = np.clip(clean.numpy() * vignette, 0.0, 1.0)
    rng = np.random.default_rng(1)

    def init_g():
        return Gaussians.from_points(
            gt.means.numpy() + rng.normal(scale=0.02, size=(40, 3))
            .astype(np.float32), colors=np.full((40, 3), 0.5, np.float32),
            sh_degree=1, init_scale=np.full((40,), 0.05, np.float32),
            device="cpu")

    final = {}
    for mode in ("off", "exposure", "bilagrid"):
        cfg = TrainConfig(iterations=100, render=rcfg, densify_from=10_000,
                          opacity_reset_interval=10_000, scene_extent=1.0,
                          impl="reference", log_every=25,
                          exposure=mode == "exposure", exposure_lr=5e-3,
                          bilateral_grid=mode == "bilagrid",
                          bilagrid_shape=(6, 6, 3), bilagrid_lr=5e-3,
                          bilagrid_tv_lambda=1.0)
        trainer = Trainer(cfg, init_g(), frames)
        trainer.run(progress=False)
        final[mode] = trainer.history[-1]["psnr"]
    assert final["bilagrid"] > final["off"] + 1.0, final
    assert final["bilagrid"] > final["exposure"] + 0.5, final
