"""Optimizer parity: the port's per-group Adam (train/optim.py) against
the JAX package's optax multi_transform, from one state converted with
core/convert.py: several steps, a densify slot reset, the opacity
reset's moment zeroing (which also zeroes that group's Adam count) and
more steps; the means lr schedule reads its count before incrementing."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from robosimgs_tpu.core.types import Gaussians as JGaussians
from robosimgs_tpu.train import optim as jo
from robosimgs_tpu.train.trainer import _zero_opacity_moments as jzero

from robosimgs_tpu_torch.core.convert import (gaussians_from_numpy,
                                              opt_state_from_numpy, to_numpy)
from robosimgs_tpu_torch.train import optim as to
from robosimgs_tpu_torch.train.trainer import _zero_opacity_moments as tzero

# short schedule: the means lr moves every step and then clamps at final
CFG = dict(means_lr_max_steps=4)
EXTENT = 2.0


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=np.shape(v)).astype(np.float32)
            for k, v in params.items()}


def _assert_states(port_state, port_params, jstate, jparams):
    want = to_numpy(opt_state_from_numpy(jax.device_get(jstate), "cpu"))
    got = to_numpy(port_state)
    for k in to.FLOAT_FIELDS:
        for f in ("count", "sched_count"):
            assert np.array_equal(got[k][f], want[k][f]), (k, f)
        # f32 Adam arithmetic in another order: a few ulps
        for f in ("mu", "nu"):
            np.testing.assert_allclose(got[k][f], want[k][f], rtol=1e-5,
                                       atol=1e-12, err_msg=f"{k} {f}")
        np.testing.assert_allclose(port_params[k].numpy(),
                                   np.asarray(jparams[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_group_adam_matches_optax_through_resets():
    jg = JGaussians.random(jax.random.PRNGKey(0), 24, sh_degree=2)
    jopt = jo.make_optimizer(jo.OptimConfig(**CFG), EXTENT)
    jparams = jo.float_params(jg)
    jstate = jopt.init(jparams)
    topt = to.make_optimizer(to.OptimConfig(**CFG), EXTENT)
    tparams = to.float_params(gaussians_from_numpy(jax.device_get(jg), "cpu"))
    tstate = opt_state_from_numpy(jax.device_get(jstate), "cpu")
    assert tstate["means"].sched_count is not None
    assert tstate["quats"].sched_count is None

    def steps(seeds, jparams, jstate, tparams, tstate):
        for s in seeds:
            g = _grads(tparams, s)
            upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                      jstate, jparams)
            jparams = optax.apply_updates(jparams, upd)
            tparams, tstate = topt.step(
                tparams, {k: torch.from_numpy(v) for k, v in g.items()},
                tstate)
        return jparams, jstate, tparams, tstate

    jparams, jstate, tparams, tstate = steps([1, 2, 3], jparams, jstate,
                                             tparams, tstate)
    _assert_states(tstate, tparams, jstate, jparams)
    assert int(tstate["logit_opacities"].count) == 3

    # densify: respawned slots lose their moments, counts survive
    mask = np.zeros(24, bool)
    mask[[1, 5, 6, 20]] = True
    jstate = jo.reset_slots_in_opt_state(jstate, jnp.asarray(mask))
    tstate = to.reset_slots_in_opt_state(tstate, torch.from_numpy(mask))
    _assert_states(tstate, tparams, jstate, jparams)
    assert (to_numpy(tstate)["means"]["mu"][mask] == 0).all()
    assert int(tstate["means"].count) == 3

    # opacity reset: the whole opacity group state zeroed, count 3 -> 0
    jstate, tstate = jzero(jstate), tzero(tstate)
    _assert_states(tstate, tparams, jstate, jparams)
    assert int(tstate["logit_opacities"].count) == 0
    assert int(tstate["quats"].count) == 3

    # more steps: the opacity bias correction restarts, the means lr
    # passes max_steps and clamps at its final value
    jparams, jstate, tparams, tstate = steps([4, 5, 6], jparams, jstate,
                                             tparams, tstate)
    _assert_states(tstate, tparams, jstate, jparams)
    assert int(tstate["means"].sched_count) == 6


def test_means_schedule_matches_optax():
    cfg = to.OptimConfig(means_lr_max_steps=10)
    sched = to.means_schedule(cfg, EXTENT)
    jsched = jo._means_schedule(jo.OptimConfig(means_lr_max_steps=10), EXTENT)
    for c in (0, 1, 5, 10, 25):
        np.testing.assert_allclose(
            float(sched(torch.tensor(c, dtype=torch.int32))),
            float(jsched(jnp.int32(c))), rtol=1e-6)
    np.testing.assert_allclose(float(sched(torch.tensor(0))),
                               1.6e-4 * EXTENT, rtol=1e-6)
