"""Densification parity: the port's train/densify.py against the JAX
package's on one converted scene and state. The split draws are the JAX
side's (jax.random differs from torch.Generator), handed to the port's
`_densify_with_draws`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosimgs_tpu.core.types import Gaussians as JGaussians
from robosimgs_tpu.train import densify as jd
from robosimgs_tpu.train.optim import float_params as jfloat_params
from robosimgs_tpu.train.optim import make_optimizer as jmake_optimizer

from robosimgs_tpu_torch.core.convert import (densify_state_from_numpy,
                                              gaussians_from_numpy,
                                              opt_state_from_numpy, to_numpy)
from robosimgs_tpu_torch.train import densify as td


def _port(x):
    return gaussians_from_numpy(jax.device_get(x), "cpu")


def _assert_gaussians(g, jg, atol=1e-6):
    want = jax.device_get(jg)
    for f in dataclasses.fields(g):
        got, exp = getattr(g, f.name).numpy(), np.asarray(getattr(want, f.name))
        if got.dtype == bool:
            np.testing.assert_array_equal(got, exp, err_msg=f.name)
        else:
            np.testing.assert_allclose(got, exp, atol=atol, rtol=1e-6,
                                       err_msg=f.name)


def _scene(n_alive, capacity, seed=0):
    return JGaussians.random(jax.random.PRNGKey(seed), n_alive, sh_degree=1,
                             capacity=capacity)


def _stats(capacity, hot, seed=1):
    rng = np.random.default_rng(seed)
    accum = np.zeros(capacity, np.float32)
    accum[hot] = rng.uniform(0.5, 2.0, len(hot))
    count = np.zeros(capacity, np.int32)
    count[:capacity // 2] = rng.integers(1, 4, capacity // 2)
    radii = rng.uniform(0, 30, capacity).astype(np.float32)
    return jd.DensifyState(grad_accum=jnp.asarray(accum),
                           count=jnp.asarray(count),
                           max_radii=jnp.asarray(radii))


def _run_both(jg, jstate, cfg, key, **kw):
    jout = jax.jit(jd.densify_and_prune, static_argnums=(3, 4, 5, 6))(
        jg, jstate, key, cfg, 1.0, kw.get("enable_scale_prune", True), True)
    k1, k2 = jax.random.split(key)
    n = jg.capacity
    draws = [torch.from_numpy(np.array(jax.random.normal(k, (n, 3))))
             for k in (k1, k2)]
    tout = td._densify_with_draws(
        _port(jg), densify_state_from_numpy(jax.device_get(jstate), "cpu"),
        *draws, td.DensifyConfig(**dataclasses.asdict(cfg)), 1.0,
        return_info=True, **kw)
    return jout, tout


def test_update_stats_matches_jax():
    rng = np.random.default_rng(0)
    n = 50
    state = jd.DensifyState(
        grad_accum=jnp.asarray(rng.uniform(0, 1, n).astype(np.float32)),
        count=jnp.asarray(rng.integers(0, 5, n).astype(np.int32)),
        max_radii=jnp.asarray(rng.uniform(0, 9, n).astype(np.float32)))
    grad2d = rng.normal(size=(n, 2)).astype(np.float32) * 1e-3
    radii = rng.uniform(0, 20, n).astype(np.float32)
    valid = rng.uniform(size=n) > 0.3
    want = jd.update_stats(state, jnp.asarray(grad2d), jnp.asarray(radii),
                           jnp.asarray(valid), 200, 100)
    got = td.update_stats(densify_state_from_numpy(jax.device_get(state), "cpu"),
                          torch.from_numpy(grad2d), torch.from_numpy(radii),
                          torch.from_numpy(valid), 200, 100)
    for k, v in to_numpy(got).items():
        np.testing.assert_allclose(v, np.asarray(getattr(want, k)), rtol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("scale_prune", [False, True])
def test_clone_split_prune_match_jax(scale_prune):
    cap = 64
    jg = _scene(24, cap)
    ls = np.array(jg.log_scales)
    ls[0] = np.log(1e-4)          # small: clone
    ls[1] = np.log(0.5)           # big: split (and scale-pruned when on)
    ls[2] = np.log(0.05)          # split
    lo = np.array(jg.logit_opacities)
    lo[5] = -12.0                 # transparent: pruned
    jg = jg.replace(log_scales=jnp.asarray(ls), logit_opacities=jnp.asarray(lo))
    cfg = jd.DensifyConfig(grad_threshold=0.4)
    jstate = _stats(cap, hot=[0, 1, 2, 3, 7, 9])
    (jg2, js2, jspawn, jinfo), (g2, s2, spawn, info) = _run_both(
        jg, jstate, cfg, jax.random.PRNGKey(3), enable_scale_prune=scale_prune)
    _assert_gaussians(g2, jg2)
    np.testing.assert_array_equal(spawn.numpy(), np.asarray(jspawn))
    for k in ("requested", "spawned", "pruned"):
        assert int(info[k]) == int(jinfo[k]), k
    assert int(info["pruned"]) >= 1 and int(info["spawned"]) >= 4
    assert float(s2.grad_accum.abs().sum()) == 0.0
    assert bool(g2.alive[1]) != scale_prune or int(g2.num_alive) > 24


def test_densify_saturation_matches_jax():
    """More candidates than free slots: the best-scoring win, the pool
    fills, nothing errors."""
    cap = 32
    jg = _scene(30, cap, seed=4)
    accum = jnp.where(jg.alive, jnp.linspace(0.2, 1.0, cap), 0.0)
    jstate = jd.DensifyState(grad_accum=accum,
                             count=jnp.ones(cap, jnp.int32),
                             max_radii=jnp.zeros(cap))
    cfg = jd.DensifyConfig(grad_threshold=0.1, prune_opacity=0.0)
    (jg2, _, jspawn, jinfo), (g2, _, spawn, info) = _run_both(
        jg, jstate, cfg, jax.random.PRNGKey(5))
    _assert_gaussians(g2, jg2)
    np.testing.assert_array_equal(spawn.numpy(), np.asarray(jspawn))
    assert int(g2.num_alive) == cap
    assert int(info["requested"]) > int(info["spawned"]) == 2


def test_densify_and_prune_with_generator_is_seeded():
    g = _port(_scene(20, 48))
    state = densify_state_from_numpy(jax.device_get(_stats(48, [0, 1, 2])),
                                     "cpu")
    cfg = td.DensifyConfig(grad_threshold=0.4, percent_dense=0.0)
    a = td.densify_and_prune(g, state, torch.Generator().manual_seed(7), cfg,
                             1.0)
    b = td.densify_and_prune(g, state, torch.Generator().manual_seed(7), cfg,
                             1.0)
    np.testing.assert_array_equal(a[0].means.numpy(), b[0].means.numpy())
    assert int(a[0].num_alive) == 23          # three splits


@pytest.mark.parametrize("new_cap", [64, 96, 160])
def test_compact_and_resize_matches_jax(new_cap):
    """Shrink, keep and grow a pool whose 60 live slots are scattered,
    with nonzero Adam moments and densify statistics riding along."""
    jg = JGaussians.random(jax.random.PRNGKey(0), 60, sh_degree=1,
                           capacity=96)
    perm = np.random.default_rng(3).permutation(96)
    jg = jax.tree_util.tree_map(lambda x: x[perm], jg)
    jopt = jmake_optimizer().init(jfloat_params(jg))
    jopt = jax.tree_util.tree_map(
        lambda x: x + jnp.arange(x.shape[0], dtype=x.dtype).reshape(
            (-1,) + (1,) * (x.ndim - 1))
        if x.ndim >= 1 and x.shape[0] == 96 else x, jopt)
    jstate = _stats(96, [1, 2, 3])
    jout = jax.jit(jd.compact_and_resize, static_argnums=3)(jg, jopt, jstate,
                                                            new_cap)
    g2, opt2, s2 = td.compact_and_resize(
        _port(jg), opt_state_from_numpy(jax.device_get(jopt), "cpu"),
        densify_state_from_numpy(jax.device_get(jstate), "cpu"), new_cap)
    _assert_gaussians(g2, jout[0], atol=0)
    want = to_numpy(opt_state_from_numpy(jax.device_get(jout[1]), "cpu"))
    got = to_numpy(opt2)
    for k in want:
        for f in want[k]:
            np.testing.assert_array_equal(got[k][f], want[k][f],
                                          err_msg=f"{k} {f}")
    for k, v in to_numpy(s2).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jout[2], k)))
    assert g2.capacity == new_cap and int(g2.num_alive) == 60
    assert bool(g2.alive[:60].all())


def test_reset_opacities_matches_jax():
    jg = _scene(10, 10)
    want = jd.reset_opacities(jg, 0.01)
    got = td.reset_opacities(_port(jg), 0.01)
    np.testing.assert_allclose(got.logit_opacities.numpy(),
                               np.asarray(want.logit_opacities), rtol=1e-6)
    assert float(got.opacities().max()) <= 0.0101
