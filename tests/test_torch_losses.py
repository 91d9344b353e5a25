"""Losses parity: the port's train/losses.py against the JAX package's on
the same seeded images, values and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosimgs_tpu.train import losses as jl

from robosimgs_tpu_torch.train import losses as tl


def _images(seed, shape=(24, 40, 3)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + 0.15 * rng.normal(size=shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name", ["l1_loss", "psnr", "ssim",
                                  "photometric_loss"])
def test_loss_values_and_grads_match_jax(name):
    a, b = _images(0)
    jf, tf = getattr(jl, name), getattr(tl, name)
    jv, jg = jax.value_and_grad(jf)(jnp.asarray(a), jnp.asarray(b))
    x = torch.from_numpy(a).requires_grad_()
    tv = tf(x, torch.from_numpy(b))
    tv.backward()
    # f32 sums over ~3k pixels in another order: 1e-5 relative
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-7)


def test_ssim_identity_and_noise():
    a, b = _images(1, (32, 32, 3))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert float(tl.ssim(ta, ta)) > 0.999
    assert float(tl.ssim(ta, tb)) < 0.95
    np.testing.assert_allclose(
        float(tl.psnr(torch.zeros(8, 8, 3), torch.full((8, 8, 3), 0.1))),
        20.0, atol=1e-3)


def test_normals_from_depth_matches_jax():
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:20, 0:28].astype(np.float32)
    depth = (2.0 + 0.02 * xx + 0.01 * yy
             + 0.01 * rng.normal(size=xx.shape)).astype(np.float32)
    fx, fy, cx, cy = 30.0, 31.0, 14.0, 10.0
    jn, jv = jl.normals_from_depth(jnp.asarray(depth), fx, fy, cx, cy)

    def jsum(d):
        n, v = jl.normals_from_depth(d, fx, fy, cx, cy)
        return jnp.sum(jnp.where(v[..., None], n * jnp.asarray([1., 2., 3.]),
                                 0.0))

    jg = jax.grad(jsum)(jnp.asarray(depth))
    d = torch.from_numpy(depth).requires_grad_()
    tn, tv = tl.normals_from_depth(d, fx, fy, cx, cy)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tn.detach().numpy(), np.asarray(jn), atol=1e-5)
    torch.where(tv[..., None], tn * torch.tensor([1., 2., 3.]), 0.0).sum() \
        .backward()
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(jg), rtol=1e-3,
                               atol=1e-4)
