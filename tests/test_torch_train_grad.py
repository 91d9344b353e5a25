"""End-to-end gradient parity: project -> bin -> composite (the port's
`Composite` autograd op, its plain versions on the CPU) against jax.grad
of the JAX package's composite_tiled (Pallas in interpret mode), for
every trainable field, the means2d_offset and abs_probe probes and a
depth loss; and the reference impl's autograd against jax.grad of the
JAX reference compositor. Cases follow tests/test_tiled.py (:123, :246,
:390, :424) on the same seeded scenes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosimgs_tpu.core.camera import Camera as JCamera
from robosimgs_tpu.core.types import Gaussians as JGaussians
from robosimgs_tpu.render.config import RenderConfig as JConfig
from robosimgs_tpu.render.project import project as jproject
from robosimgs_tpu.render.reference import composite_reference as jreference
from robosimgs_tpu.render.tiled import composite_tiled as jtiled

from robosimgs_tpu_torch.core.convert import (camera_from_numpy,
                                              gaussians_from_numpy)
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.project import project
from robosimgs_tpu_torch.render.reference import composite_reference
from robosimgs_tpu_torch.render.tiled import composite_tiled

FIELDS = ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
          "sh_rest")
KW = dict(tile_capacity=256, max_tiles_per_gaussian=64, ref_gaussian_chunk=64)
# test_tiled.py:146's tolerances for full-pipeline gradients
ATOL, RTOL = 2e-5, 2e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _camera(eye=(4.0, 0.3, 0.8), w=48, h=32, fov=60.0):
    return JCamera.look_at(list(eye), [0, 0, 0], [0, 0, 1], fov, w, h)


def _grads_both(jg, jcam, kw, loss, impl="tiled", probes=("offset",)):
    """(jax grads, port grads): dicts over FIELDS and the probes of
    `loss(out)` (an op on the compositor's output dict, written once for
    both: it only uses +, -, *, /, comparisons and .sum()/.mean())."""
    W, H = jcam.width, jcam.height
    n = jg.capacity
    zeros = np.zeros((n, 2), np.float32)

    def jfn(params, offset, absp):
        gg = jg.replace(**params)
        p = jproject(gg, jcam, JConfig(**kw), means2d_offset=offset,
                     abs_probe=absp)
        out = (jtiled(p, W, H, JConfig(**kw)) if impl == "tiled"
               else jreference(p, W, H, JConfig(**kw)))
        return loss(out, jnp)

    jparams = {k: getattr(jg, k) for k in FIELDS}
    absp = jnp.asarray(zeros) if "absgrad" in probes else None
    argnums = (0, 1, 2) if absp is not None else (0, 1)
    jgr = jax.jit(jax.grad(jfn, argnums=argnums))(jparams, jnp.asarray(zeros),
                                                  absp)
    want = {k: np.asarray(v) for k, v in jgr[0].items()}
    want["offset"] = np.asarray(jgr[1])
    if absp is not None:
        want["absgrad"] = np.asarray(jgr[2])

    g = gaussians_from_numpy(jax.device_get(jg), "cpu")
    cam = camera_from_numpy(jax.device_get(jcam), "cpu")
    params = {k: getattr(g, k).clone().requires_grad_() for k in FIELDS}
    offset = torch.zeros((n, 2), requires_grad=True)
    tabsp = torch.zeros((n, 2), requires_grad=True) if absp is not None else None
    cfg = RenderConfig(**kw)
    p = project(g.replace(**params), cam, cfg, means2d_offset=offset,
                abs_probe=tabsp)
    out = (composite_tiled(p, W, H, cfg) if impl == "tiled"
           else composite_reference(p, W, H, cfg))
    loss(out, torch).backward()
    got = {k: v.grad.numpy() for k, v in params.items()}
    got["offset"] = offset.grad.numpy()
    if tabsp is not None:
        got["absgrad"] = tabsp.grad.numpy()
    return want, got


def _assert_grads(want, got, atol=ATOL, rtol=RTOL):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol,
                                   err_msg=k)


def _rgb_mse(out, xp):
    return ((out["rgb"] - 0.4) ** 2).mean()


@pytest.mark.parametrize("impl", ["tiled", "reference"])
def test_end_to_end_grads_match_jax(impl):
    """test_tiled.py:123's scene: every trainable field (sh_rest too,
    SH degree 1) and the densification probe means2d_offset."""
    jg = JGaussians.random(jax.random.PRNGKey(6), 60, sh_degree=1)
    want, got = _grads_both(jg, _camera(), KW, _rgb_mse, impl=impl)
    _assert_grads(want, got)
    assert np.abs(got["means"]).max() > 1e-4
    assert np.abs(got["sh_rest"]).max() > 1e-5
    assert np.abs(got["offset"]).max() > 1e-5


def test_absgrad_probe_matches_jax():
    """test_tiled.py:246's setting: the abs_probe's gradient is the
    kernel's per-pixel |screen grad| sum, >= the signed probe's."""
    kw = dict(KW, tile_capacity=128, absgrad=True)
    jg = JGaussians.random(jax.random.PRNGKey(5), 20, sh_degree=1)
    wts = np.random.default_rng(6).uniform(size=(32, 32, 3)).astype(np.float32)

    def loss(out, xp):
        w = jnp.asarray(wts) if xp is jnp else torch.from_numpy(wts)
        return (out["rgb"] * w).sum()

    want, got = _grads_both(jg, _camera((3.0, 0.4, 0.8), 32, 32, 55.0), kw,
                            loss, probes=("offset", "absgrad"))
    _assert_grads(want, got, atol=1e-5)
    assert got["absgrad"].max() > 1e-4
    assert (got["absgrad"] >= np.abs(got["offset"]) - 1e-5).all()


def test_depth_gradient_matches_jax():
    """test_tiled.py:424: an alpha-normalized depth L1 rides feat row 3
    through the backward kernel."""
    jcam = _camera()
    jg = JGaussians.random(jax.random.PRNGKey(9), 60, sh_degree=1)
    ref0 = jreference(jproject(jg, jcam, JConfig(**KW)), 48, 32, JConfig(**KW))
    tgt = np.array(ref0["depth"] / jnp.maximum(ref0["alpha"], 1e-6))
    valid = np.array(ref0["alpha"]) > 0.25

    def loss(out, xp):
        if xp is jnp:
            t, v = jnp.asarray(tgt), jnp.asarray(valid)
            d = out["depth"] / jnp.maximum(out["alpha"], 1e-6)
            return jnp.sum(jnp.where(v, jnp.abs(d - t + 0.05), 0.0)) / v.sum()
        t, v = torch.from_numpy(tgt), torch.from_numpy(valid)
        d = out["depth"] / torch.clamp_min(out["alpha"], 1e-6)
        return torch.where(v, torch.abs(d - t + 0.05), 0.0).sum() / v.sum()

    want, got = _grads_both(jg, jcam, KW, loss)
    assert np.linalg.norm(want["means"]) > 1e-4
    _assert_grads(want, got)


def test_saturated_pixel_gradients_match_jax():
    """test_tiled.py:390's scene: 64 stacked near-opaque splats; linear T
    underflows to 0 and the front splats' gradients are rebuilt from
    log-T, not zeroed."""
    n = 64
    jg = JGaussians.random(jax.random.PRNGKey(0), n, sh_degree=1)
    means = np.zeros((n, 3), np.float32)
    means[:, 0] = np.linspace(-0.01, 0.01, n)
    jg = jg.replace(means=jnp.asarray(means),
                    logit_opacities=jnp.full((n,), 6.0))
    kw = dict(tile_capacity=128)

    def loss(out, xp):
        return (out["rgb"] ** 2).sum()

    want, got = _grads_both(jg, _camera((2.5, 0.0, 0.0), 32, 32, 45.0), kw,
                            loss)
    assert np.linalg.norm(got["means"]) > 0.1
    _assert_grads(want, got, atol=1e-4, rtol=1e-3)
