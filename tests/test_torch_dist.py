"""Multi-rank parity: the port's parallel/distributed.py on 4 spawned
gloo ranks on the CPU (tools/dist_run.py: one spawn runs every case of
the module) against the JAX package's shard_map steps on
jax.devices()[:4], from one TrainState carried across with
core/convert.py. Tolerances are tests/test_dist.py's: loss rtol 1e-5,
every gradient atol 2e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosimgs_tpu.parallel import distributed as jdist
from robosimgs_tpu.parallel.mesh import make_mesh as jmake_mesh
from robosimgs_tpu.train.optim import float_params as jfloat_params
from robosimgs_tpu.train.optim import make_optimizer as jmake_optimizer
from tests.test_dist import _densify_setup, setup

from robosimgs_tpu_torch.core.convert import (camera_from_numpy,
                                              shard_train_state_from_numpy,
                                              train_state_from_numpy)
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.rasterize import rasterize
from robosimgs_tpu_torch.tools import dist_run
from robosimgs_tpu_torch.train.densify import DensifyConfig
from robosimgs_tpu_torch.train.losses import photometric_loss
from robosimgs_tpu_torch.train.trainer import TrainConfig

WORLD = 4
DP_MESHES = [(2, 2), (4, 1), (1, 4)]
CFG = TrainConfig(render=RenderConfig(tile_capacity=128,
                                      ref_gaussian_chunk=64),
                  scene_extent=1.0, impl="reference")
DENSIFY_CFG = TrainConfig(scene_extent=1.0, impl="reference",
                          densify=DensifyConfig(grad_threshold=0.5,
                                                percent_dense=1.0))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _copy(state):
    return jax.tree_util.tree_map(
        lambda x: jnp.copy(x) if isinstance(x, jax.Array) else x, state)


def _cams(frames):
    return [camera_from_numpy(jax.device_get(f.camera), "cpu")
            for f in frames]


def _alive_rows(g):
    """Sorted rows of every alive Gaussian (slot-assignment invariant),
    of a numpy dict or a JAX Gaussians."""
    get = (lambda k: np.asarray(g[k])) if isinstance(g, dict) else \
        (lambda k: np.asarray(getattr(g, k)))
    alive = get("alive")
    rows = np.concatenate([get("means")[alive], get("log_scales")[alive],
                           get("logit_opacities")[alive][:, None],
                           get("sh_dc")[alive]], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def _shards(jstate, n):
    return [shard_train_state_from_numpy(_np(jstate), n, r, "cpu")
            for r in range(n)]


def _moment_state(cfg, state):
    """tests/test_dist.py's compaction fixture: one update's moments
    (mu = 0.1 * param), so moved moments stay tied to their slots."""
    optimizer = jmake_optimizer(cfg.optim, cfg.scene_extent)
    params = jfloat_params(state.gaussians)
    _, opt_state = optimizer.update(params, state.opt_state, params)
    return dataclasses.replace(state, opt_state=opt_state)


@pytest.fixture(scope="module")
def jax_inputs():
    inputs = {}
    for shape in DP_MESHES:
        jcfg, frames, targets, state, _ = setup(n_cams=shape[0])
        inputs[shape] = (frames, np.stack(targets), state)
    _, frames1, targets1, state1, _ = setup(n_cams=1)
    inputs["gs"] = (frames1, np.asarray(targets1[0]), state1)
    inputs["cfg"] = jcfg
    inputs["densify_cfg"], dstate = _densify_setup()
    _, sat = _densify_setup(alive_per_shard=16, hot_per_shard=16,
                            prune_per_shard=0)
    inputs["densify"] = dstate
    inputs["saturated"] = sat
    inputs["compact"] = _moment_state(DENSIFY_CFG, dstate)
    return inputs


@pytest.fixture(scope="module")
def results(jax_inputs):
    """Every world-4 case, in one spawn of 4 gloo ranks."""
    cases = []
    for shape in DP_MESHES:
        frames, targets, state = jax_inputs[shape]
        cases.append((f"dp{shape}", dist_run.dp_step, dict(
            mesh_shape=shape, cfg=CFG, impl="reference",
            state=train_state_from_numpy(_np(state), "cpu"),
            cams=_cams(frames), targets=targets)))
    frames, targets, state = jax_inputs[(2, 2)]
    tiled = dict(cfg=CFG, impl="tiled",
                 state=train_state_from_numpy(_np(state), "cpu"),
                 cams=_cams(frames), targets=targets)
    cases.append(("tiled4", dist_run.dp_step,
                  dict(mesh_shape=(2, 2), **tiled)))
    cases.append(("tiled1", dist_run.dp_step,
                  dict(mesh_shape=(1, 1), ranks=[0], **tiled)))
    frames1, target1, state1 = jax_inputs["gs"]
    cases.append(("gs", dist_run.gs_step, dict(
        mesh_shape=(2, 2), cfg=CFG, impl="reference", gather="all_gather",
        shards=_shards(state1, 2), camera=_cams(frames1)[0],
        target=target1)))
    for name in ("densify", "saturated"):
        cases.append((name, dist_run.densify, dict(
            mesh_shape=(4, 1), cfg=DENSIFY_CFG,
            shards=_shards(jax_inputs[name], 4))))
    cases.append(("compact", dist_run.compact_then_step, dict(
        mesh_shape=(4, 1), cfg=DENSIFY_CFG,
        shards=_shards(jax_inputs["compact"], 4), headroom=0.1, bucket=4,
        local_max=16, camera=_cams(frames1)[0], target=target1)))
    return dist_run.run_ranks(dist_run.run_cases, WORLD, args=(cases,))


@pytest.mark.parametrize("mesh_shape", DP_MESHES)
def test_dp_step_matches_jax(jax_inputs, results, mesh_shape):
    frames, targets, state = jax_inputs[mesh_shape]
    jmesh = jmake_mesh(*mesh_shape, devices=jax.devices()[:WORLD])
    step = jdist.make_dp_train_step(jax_inputs["cfg"], jmesh,
                                    impl="reference",
                                    return_grads=True)
    jcams = jdist.stack_cameras([f.camera for f in frames])
    _, want = step(_copy(state), jcams, jnp.asarray(targets))
    for rank, got in enumerate(results):
        got = got[f"dp{mesh_shape}"]
        np.testing.assert_allclose(got["loss"], float(want["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(got["psnr"], float(want["psnr"]),
                                   rtol=1e-5)
        assert int(got["step"]) == 1 and int(got["n_alive"]) == 40
        for k, w in want["grads"].items():
            np.testing.assert_allclose(got["grads"][k], np.asarray(w),
                                       atol=2e-6,
                                       err_msg=f"{k} rank {rank}")


def test_dp_tiled_world4_matches_world1(results):
    """The tiled impl (the kernels' plain versions on the CPU) at a
    (2, 2) mesh against one rank on the same two cameras."""
    want = results[0]["tiled1"]
    assert all(r["tiled1"] is None for r in results[1:])
    for r in results:
        got = r["tiled4"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        for k, w in want["grads"].items():
            np.testing.assert_allclose(got["grads"][k], w, atol=2e-6,
                                       err_msg=k)
        np.testing.assert_allclose(got["densify"]["grad_accum"],
                                   want["densify"]["grad_accum"], atol=2e-6)
        np.testing.assert_array_equal(got["densify"]["count"],
                                      want["densify"]["count"])


def test_gaussian_sharded_step_matches_jax(jax_inputs, results):
    frames, target, state = jax_inputs["gs"]
    jmesh = jmake_mesh(2, 2, devices=jax.devices()[:WORLD])
    step = jdist.make_gaussian_sharded_train_step(
        jax_inputs["cfg"], jmesh, impl="reference", return_grads=True)
    _, want = step(_copy(state), frames[0].camera, jnp.asarray(target))
    # rank r holds shard r // n_tile; tile rank 0's rows, in shard order
    got = [results[0]["gs"], results[2]["gs"]]
    for r in results:
        np.testing.assert_allclose(r["gs"]["loss"], float(want["loss"]),
                                   rtol=1e-5)
        assert int(r["gs"]["n_alive"]) == int(want["n_alive"]) == 40
    for k, w in want["grads"].items():
        np.testing.assert_allclose(
            np.concatenate([g["grads"][k] for g in got]), np.asarray(w),
            atol=2e-6, err_msg=k)
    # the tile ranks of a shard agree
    for k in want["grads"]:
        np.testing.assert_array_equal(results[0]["gs"]["grads"][k],
                                      results[1]["gs"]["grads"][k])


def _jax_densify(jax_inputs, name):
    jmesh = jmake_mesh(4, 1, devices=jax.devices()[:WORLD])
    return jdist.make_sharded_densify_step(jax_inputs["densify_cfg"], jmesh)(
        _copy(jax_inputs[name]), True)


def test_sharded_densify_matches_jax_clone_only(jax_inputs, results):
    """Clone-only round (no draws): the same grow / prune decisions as
    JAX's, the same alive content, spawned slots' moments zeroed."""
    want_state, want_info = _jax_densify(jax_inputs, "densify")
    for r in results:
        info = r["densify"]["info"]
        assert {k: int(v) for k, v in info.items()} == \
            {k: int(v) for k, v in want_info.items()} == \
            {"requested": 12, "spawned": 12, "pruned": 4}
        got = r["densify"]["state"]
        assert int(got["gaussians"]["alive"].sum()) == 4 * (10 + 3 - 1)
        np.testing.assert_array_equal(_alive_rows(got["gaussians"]),
                                      _alive_rows(want_state.gaussians))
        assert np.abs(got["densify_state"]["grad_accum"]).max() == 0.0


def test_sharded_densify_saturation_is_counted(jax_inputs, results):
    _, want_info = _jax_densify(jax_inputs, "saturated")
    for r in results:
        info = {k: int(v) for k, v in r["saturated"]["info"].items()}
        assert info == {k: int(v) for k, v in want_info.items()}
        assert info["requested"] == 64 and info["spawned"] == 0
        assert int(r["saturated"]["state"]["gaussians"]["alive"].sum()) == 64


def test_sharded_compact_pool_target_then_step(jax_inputs, results):
    """sharded_pool_target (max over shards) and make_sharded_compact
    against JAX's, moments moved with their slots, then a
    gaussian-sharded step at the new capacity against JAX's."""
    state = jax_inputs["compact"]
    frames, target, _ = jax_inputs["gs"]
    jmesh = jmake_mesh(4, 1, devices=jax.devices()[:WORLD])
    local = jdist.sharded_pool_target(state, jmesh, headroom=0.1, bucket=4,
                                      local_max=16)
    compacted = jdist.make_sharded_compact(jmesh)(state, local)
    step = jdist.make_gaussian_sharded_train_step(
        jax_inputs["densify_cfg"], jmesh, impl="reference")
    _, m = step(_copy(compacted), frames[0].camera, jnp.asarray(target))
    for r in results:
        got = r["compact"]
        assert int(got["local"]) == local == 12
        g = got["state"]["gaussians"]
        assert g["means"].shape[0] == 4 * int(got["capacity"]) == 48
        np.testing.assert_array_equal(_alive_rows(g),
                                      _alive_rows(compacted.gaussians))
        np.testing.assert_array_equal(g["alive"],
                                      np.asarray(compacted.gaussians.alive))
        mu = got["state"]["opt_state"]["means"]["mu"]
        np.testing.assert_allclose(mu[g["alive"]],
                                   0.1 * g["means"][g["alive"]], rtol=1e-6)
        np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-5)
        assert int(got["step"]) == 6


def test_initialize_multihost_two_processes(jax_inputs):
    """Two processes joined by initialize_multihost over
    tcp://127.0.0.1: the DP step's loss within 1e-6 of one process's
    (the counterpart of tests/test_multihost.py)."""
    frames, targets, state = jax_inputs[(2, 2)]
    cams = _cams(frames)
    port_state = train_state_from_numpy(_np(state), "cpu")
    kw = dict(mesh_shape=(2, 1), cfg=CFG, impl="reference",
              state=port_state, cams=cams, targets=targets)
    out = dist_run.run_ranks(
        dist_run.multihost_dp, 2, backend=None,
        args=(f"127.0.0.1:{dist_run.free_port()}", kw))
    g = port_state.gaussians.replace(sh_rest=port_state.gaussians.sh_rest
                                     * 0.0)
    with torch.no_grad():
        single = sum(photometric_loss(
            rasterize(g, c, CFG.render, impl="reference")["rgb"],
            torch.from_numpy(t), CFG.ssim_lambda)
            for c, t in zip(cams, targets)) / len(cams)
    for r in out:
        assert abs(float(r["loss"]) - float(single)) < 1e-6


def test_dryrun_multichip_cpu():
    """tools/dryrun.py on 2 gloo ranks: every sharded path once, one
    summary line (the JAX package's dryrun_multichip's)."""
    from robosimgs_tpu_torch.tools.dryrun import dryrun_multichip
    line = dryrun_multichip(2, device="cpu")
    assert line.startswith("dryrun_multichip(2): mesh=(1x2) ")
    assert line.endswith(" ok") and "densify_spawned=8" in line
