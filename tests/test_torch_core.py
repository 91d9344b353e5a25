"""Core parity: cameras, covariance, SH and Gaussian activations of the
port against the JAX package on the same numpy inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosimgs_tpu.core import math3d as jmath3d
from robosimgs_tpu.core import sh as jsh
from robosimgs_tpu.core.camera import Camera as JCamera
from robosimgs_tpu.core.types import Gaussians as JGaussians
from robosimgs_tpu.core.types import _knn_mean_dist

from robosimgs_tpu_torch.core import math3d, sh
from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.core.convert import (camera_from_numpy,
                                              gaussians_from_numpy)
from robosimgs_tpu_torch.core.types import Gaussians

ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def test_camera_look_at_w2c_resized():
    args = ([3.5, 0.5, 1.0], [0.1, -0.2, 0.0], [0, 0, 1], 55.0, 64, 48)
    jc, c = JCamera.look_at(*args), Camera.look_at(*args, device="cpu")
    np.testing.assert_allclose(c.c2w.numpy(), np.asarray(jc.c2w), atol=ATOL)
    np.testing.assert_allclose(c.w2c.numpy(), np.asarray(jc.w2c), atol=ATOL)
    np.testing.assert_allclose(c.origin.numpy(), np.asarray(jc.origin), atol=ATOL)
    for a, b in zip(c.tan_half_fov, jc.tan_half_fov):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    jr, r = jc.resized(37, 23), c.resized(37, 23)
    assert (r.width, r.height) == (37, 23)
    for k in ("fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(getattr(r, k).numpy(),
                                   np.asarray(getattr(jr, k)), atol=ATOL)


def test_camera_from_opengl():
    rng = np.random.default_rng(1)
    K = np.array([[70.0, 0, 33.0], [0, 72.0, 21.0], [0, 0, 1]], np.float32)
    Q = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3], c2w[:3, 3] = Q, [0.5, -1.0, 2.0]
    jc = JCamera.from_opengl(K, c2w, 64, 48)
    c = Camera.from_opengl(K, c2w, 64, 48, device="cpu")
    np.testing.assert_allclose(c.c2w.numpy(), np.asarray(jc.c2w), atol=ATOL)
    np.testing.assert_allclose(c.w2c.numpy(), np.asarray(jc.w2c), atol=ATOL)
    cc = camera_from_numpy(jax.device_get(jc), "cpu")
    np.testing.assert_array_equal(cc.c2w.numpy(), np.asarray(jc.c2w))
    assert (cc.width, cc.height) == (64, 48)


def test_camera_covariance_components_and_rotmat():
    rng = np.random.default_rng(2)
    q = _unit_quats(rng, 64)
    s = rng.uniform(0.01, 0.3, (64, 3)).astype(np.float32)
    R_cw = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    want = jmath3d.camera_covariance_components(jnp.asarray(q), jnp.asarray(s),
                                                jnp.asarray(R_cw))
    got = math3d.camera_covariance_components(
        torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(R_cw))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    np.testing.assert_allclose(
        math3d.quat_to_rotmat(torch.from_numpy(q)).numpy(),
        np.asarray(jmath3d.quat_to_rotmat(jnp.asarray(q))), atol=ATOL)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh(degree):
    rng = np.random.default_rng(3 + degree)
    coeffs = rng.normal(0, 0.5, (50, 16, 3)).astype(np.float32)
    dirs = rng.normal(size=(50, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    want = jsh.eval_sh(degree, jnp.asarray(coeffs), jnp.asarray(dirs))
    got = sh.eval_sh(degree, torch.from_numpy(coeffs), torch.from_numpy(dirs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert sh.num_sh_bases(degree) == jsh.num_sh_bases(degree)


def test_gaussians_activations_and_convert_round_trip():
    jg = JGaussians.random(jax.random.PRNGKey(0), 40, sh_degree=2, capacity=48)
    d = jax.device_get(jg)
    g = gaussians_from_numpy(d, "cpu")
    for f in dataclasses.fields(g):
        np.testing.assert_array_equal(getattr(g, f.name).numpy(),
                                      np.asarray(getattr(d, f.name)))
    assert (g.capacity, g.sh_degree, int(g.num_alive)) == (48, 2, 40)
    for name in ("scales", "opacities", "normalized_quats"):
        np.testing.assert_allclose(getattr(g, name)().numpy(),
                                   np.asarray(getattr(jg, name)()), atol=ATOL)


def test_from_points_matches_jax():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (30, 3)).astype(np.float32)
    scale = rng.uniform(0.01, 0.1, 30).astype(np.float32)
    jg = JGaussians.from_points(pts, cols, sh_degree=1, capacity=32,
                                init_scale=scale)
    g = Gaussians.from_points(pts, cols, sh_degree=1, capacity=32,
                              init_scale=scale, device="cpu")
    for f in dataclasses.fields(g):
        np.testing.assert_allclose(getattr(g, f.name).numpy(),
                                   np.asarray(getattr(jg, f.name)), atol=ATOL)
    # without init_scale: the 3-NN mean distance, as the JAX package's
    # numpy _knn_mean_dist gives it
    knn = Gaussians.from_points(pts, device="cpu")
    jknn = JGaussians.from_points(pts, init_scale=_knn_mean_dist(pts, k=3))
    np.testing.assert_allclose(knn.log_scales.numpy(),
                               np.asarray(jknn.log_scales), rtol=1e-5)


def test_random_is_seeded_and_shaped():
    a = Gaussians.random(torch.Generator().manual_seed(7), 20, sh_degree=3,
                         extent=1.5, device="cpu")
    b = Gaussians.random(torch.Generator().manual_seed(7), 20, sh_degree=3,
                         extent=1.5, device="cpu")
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name))
    assert a.sh_rest.shape == (20, 15, 3) and bool(a.alive.all())
    assert float(a.means.abs().max()) <= 1.5
