"""core/math3d.py parity: the port's quaternion, covariance and transform
helpers against the JAX package's on the same seeded numpy inputs,
including broadcasting over leading dimensions.

Tolerances: quat_multiply, axis_angle_to_quat and inverse_2x2_sym within
1e-6 relative (the same f32 expressions; sin/cos and the division may
round differently by an ulp); build_covariance and transform_points,
contractions of three terms summed in an order each library picks,
within 1e-6 of the largest entry; build_covariance's gradient against
jax.vjp within 1e-5 of the largest entry; det exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosimgs_tpu.core import math3d as jm

from robosimgs_tpu_torch.core import math3d as m

RNG = np.random.default_rng(0)


def _quats(*shape):
    q = RNG.standard_normal((*shape, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, rtol=1e-6, atol_of_max=None):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape and got.dtype == want.dtype
    atol = 0.0 if atol_of_max is None else atol_of_max * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("sa,sb", [((7,), (7,)), ((3, 5), (5,)),
                                   ((2, 1, 4), (3, 4)), ((), (6,))])
def test_quat_multiply_matches_jax(sa, sb):
    a, b = _quats(*sa), _quats(*sb)
    _close(m.quat_multiply(_t(a), _t(b)), jm.quat_multiply(a, b), rtol=1e-6,
           atol_of_max=1e-7)


@pytest.mark.parametrize("shape", [(9,), (2, 3)])
def test_axis_angle_to_quat_matches_jax(shape):
    axis = RNG.standard_normal((*shape, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = RNG.uniform(-np.pi, np.pi, shape).astype(np.float32)
    got = m.axis_angle_to_quat(_t(axis), _t(angle))
    _close(got, jm.axis_angle_to_quat(axis, angle), atol_of_max=1e-7)
    # unit quaternions, and one axis with a python-float angle
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, rtol=1e-6)
    one = axis.reshape(-1, 3)[0]
    _close(m.axis_angle_to_quat(_t(one), 0.7),
           jm.axis_angle_to_quat(one, 0.7), atol_of_max=1e-7)


@pytest.mark.parametrize("shape", [(64,), (4, 16), (2, 3, 5)])
def test_build_covariance_matches_jax(shape):
    q = _quats(*shape)
    s = RNG.uniform(0.01, 2.0, (*shape, 3)).astype(np.float32)
    got = m.build_covariance(_t(q), _t(s))
    _close(got, jm.build_covariance(q, s), rtol=0, atol_of_max=1e-6)
    assert torch.equal(got, got.transpose(-1, -2))


def test_build_covariance_gradient_matches_jax_vjp():
    q = _quats(3, 40)
    s = RNG.uniform(0.01, 2.0, (3, 40, 3)).astype(np.float32)
    ct = RNG.standard_normal((3, 40, 3, 3)).astype(np.float32)
    _, vjp = jax.vjp(jm.build_covariance, jnp.asarray(q), jnp.asarray(s))
    want_q, want_s = jax.device_get(vjp(jnp.asarray(ct)))
    tq, ts = _t(q).requires_grad_(), _t(s).requires_grad_()
    m.build_covariance(tq, ts).backward(_t(ct))
    _close(tq.grad, want_q, rtol=0, atol_of_max=1e-5)
    _close(ts.grad, want_s, rtol=0, atol_of_max=1e-5)


@pytest.mark.parametrize("st,sp", [((), (50,)), ((4,), (4, 20)),
                                   ((2, 3), (2, 3, 7))])
def test_transform_points_matches_jax(st, sp):
    q = _quats(*st)
    T = np.zeros((*st, 4, 4), np.float32)
    T[..., :3, :3] = np.asarray(jm.quat_to_rotmat(q))
    T[..., :3, 3] = RNG.standard_normal((*st, 3))
    T[..., 3, 3] = 1.0
    pts = RNG.standard_normal((*sp, 3)).astype(np.float32)
    _close(m.transform_points(_t(T), _t(pts)), jm.transform_points(T, pts),
           rtol=0, atol_of_max=1e-6)


def test_inverse_2x2_sym_matches_jax_including_det_zero():
    a = RNG.uniform(0.5, 3.0, (3, 8)).astype(np.float32)
    c = RNG.uniform(0.5, 3.0, (3, 8)).astype(np.float32)
    b = RNG.uniform(-0.4, 0.4, (3, 8)).astype(np.float32)
    # singular entries: [[1, 1], [1, 1]], [[0, 0], [0, 0]], [[2, 4], [4, 8]]
    for (i, j), (x, y, z) in {(0, 0): (1, 1, 1), (1, 3): (0, 0, 0),
                              (2, 7): (2, 4, 8)}.items():
        a[i, j], b[i, j], c[i, j] = x, y, z
    got = m.inverse_2x2_sym(_t(a), _t(b), _t(c))
    want = jm.inverse_2x2_sym(a, b, c)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-6)
    det = got[3].numpy()
    assert det[0, 0] == 0 and det[1, 3] == 0 and det[2, 7] == 0
    # a zero determinant divides by 1: the entries come back as they were
    assert got[0][0, 0] == 1 and got[1][0, 0] == -1 and got[2][1, 3] == 0
    assert all(bool(torch.isfinite(x).all()) for x in got)
