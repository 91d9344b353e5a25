"""The training leftovers on the port: the per-frame exposure affine and
the bilateral grid (train steps against the JAX package's from one
converted TrainState, on a black background where their clips tie),
the tint and vignette recoveries, checkpoints carrying both, and
fused_steps (the port's fused loop against its unfused one across
densify rounds, and against the JAX package's fused run before the
first densify); the train CLI with both flags on the CPU."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosimgs_tpu.core.types import Gaussians as JGaussians
from robosimgs_tpu.render.config import RenderConfig as JConfig
from robosimgs_tpu.render.rasterize import rasterize as jrasterize
from robosimgs_tpu.train import trainer as jt
from robosimgs_tpu.train.bilagrid import identity_bilagrid as jidentity_grid
from robosimgs_tpu.train.data import synthetic_scene as jsynthetic_scene
from robosimgs_tpu.train.densify import DensifyState as JDensifyState
from robosimgs_tpu.train.optim import float_params as jfloat_params
from robosimgs_tpu.train.optim import make_optimizer as jmake_optimizer

from robosimgs_tpu_torch.cli import train as cli_train
from robosimgs_tpu_torch.core.convert import (camera_from_numpy,
                                              gaussians_from_numpy,
                                              opt_state_from_numpy,
                                              to_numpy, train_state_from_numpy)
from robosimgs_tpu_torch.core.types import Gaussians
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.rasterize import rasterize
from robosimgs_tpu_torch.train import trainer as tt
from robosimgs_tpu_torch.train.data import Frame, synthetic_scene

RKW = dict(tile_capacity=128, max_tiles_per_gaussian=16, ref_gaussian_chunk=64)
FIELDS = ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
          "sh_rest")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_scene(W=32, n_cameras=3, seed=3, n=40):
    gt, jframes = jsynthetic_scene(seed=seed, n_gaussians=n,
                                   n_cameras=n_cameras, width=W, height=W,
                                   sh_degree=1)
    targets = [np.array(jrasterize(gt, f.camera, JConfig(**RKW),
                                   impl="reference")["rgb"]) for f in jframes]
    return gt, jframes, targets


def _jax_init(gt, n=40, capacity=48):
    rng = np.random.default_rng(1)
    jg = JGaussians.from_points(
        np.asarray(gt.means)[:n] + rng.normal(scale=0.05, size=(n, 3))
        .astype(np.float32), colors=np.full((n, 3), 0.5, np.float32),
        sh_degree=1, capacity=capacity,
        init_scale=np.full((n,), 0.08, np.float32))
    quats = rng.normal(size=(capacity, 4)).astype(np.float32) * 0.3
    quats[:, 0] += 1.0
    ls = np.log(0.08 * rng.uniform(0.4, 2.0, (capacity, 3))).astype(np.float32)
    return jg.replace(quats=jnp.asarray(quats), log_scales=jnp.asarray(ls))


@pytest.mark.parametrize("mode,background,tv", [
    ("exposure", 0.0, 1.0), ("bilateral_grid", 0.0, 0.0),
    ("both", 0.0, 0.0), ("bilateral_grid", 0.25, 1.0)],
    ids=["exposure", "bilateral_grid", "both", "bilateral_grid_tv_gray"])
def test_train_steps_match_jax(mode, background, tv):
    """Three tiled train steps over three frames (frame_idx 0, 1, 2) from
    one converted state, the colour correction on. On a black background
    every uncovered pixel renders exactly 0, where the exposure clip, the
    gray clip and the grid's hat weights tie. Loss, PSNR, the Gaussians,
    the exposure affines and grids, every Adam group's state and the
    densify statistics, with test_torch_trainer.py::
    test_train_steps_match_jax's tolerances.

    The grid's TV term runs on a gray background: on a black one the
    dark corner's green and blue weights see only splat tails (gradients
    near 1e-9), where the TV term's f32 rounding decides the sign of the
    gradient and Adam scales it to a step of +-lr in either package."""
    gt, jframes, targets = _jax_scene()
    # a per-frame tint the affines and grids have to absorb
    tints = np.array([[1.2, 0.9, 1.0], [0.8, 1.1, 0.9], [1.0, 1.0, 1.2]],
                     np.float32)
    targets = [np.clip(t * k, 0.0, 1.0) for t, k in zip(targets, tints)]
    jg = _jax_init(gt)
    exposure = mode in ("exposure", "both")
    grid = mode in ("bilateral_grid", "both")
    kw = dict(render=RenderConfig(**RKW), sh_warmup_every=1,
              exposure=exposure, exposure_lr=5e-3, bilateral_grid=grid,
              bilagrid_shape=(4, 4, 3), bilagrid_lr=5e-3,
              bilagrid_tv_lambda=tv, background=(background,) * 3)
    jcfg = jt.TrainConfig(**{**kw, "render": JConfig(**RKW)})
    params0 = jfloat_params(jg)
    jstate_kw = {}
    if exposure:
        params0["exposure"] = jstate_kw["exposure"] = jt.identity_exposure(3)
    if grid:
        params0["bilagrid"] = jstate_kw["bilagrid"] = jidentity_grid(
            3, (4, 4, 3))
    jstate = jt.TrainState(
        gaussians=jg, opt_state=jmake_optimizer(
            exposure_lr=5e-3 if exposure else None,
            bilagrid_lr=5e-3 if grid else None).init(params0),
        densify_state=JDensifyState.zero(48), step=jnp.int32(0),
        key=jax.random.PRNGKey(0), **jstate_kw)
    state = train_state_from_numpy(jax.device_get(jstate), "cpu")
    assert (state.exposure is not None) == exposure
    assert (state.bilagrid is not None) == grid
    jstep = jt.make_train_step(jcfg, "tiled")
    step = tt.make_train_step(tt.TrainConfig(**kw), "tiled")
    cams = [camera_from_numpy(jax.device_get(f.camera), "cpu")
            for f in jframes]
    with torch.no_grad():
        alpha = rasterize(state.gaussians, cams[0], RenderConfig(**RKW),
                          impl="tiled")["alpha"]
    assert int((alpha == 0).sum()) > 0          # uncovered pixels
    for i in range(3):
        jstate, jm = jstep(jstate, jframes[i].camera, jnp.asarray(targets[i]),
                           jnp.int32(i))
        state, m = step(state, cams[i], torch.from_numpy(targets[i]), i)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["psnr"]), float(jm["psnr"]),
                                   rtol=1e-5)
        want = jax.device_get(jstate)
        g = to_numpy(state.gaussians)
        # an Adam step moves each coordinate by about lr: parameters
        # agree to ~1e-3 of the lr wherever the gradients agree to 1e-3
        for k in FIELDS:
            np.testing.assert_allclose(g[k], np.asarray(getattr(
                want.gaussians, k)), rtol=1e-5, atol=1e-6, err_msg=k)
        opt, jopt = to_numpy(state.opt_state), to_numpy(
            opt_state_from_numpy(want.opt_state, "cpu"))
        for k, on in (("exposure", exposure), ("bilagrid", grid)):
            if not on:
                continue
            np.testing.assert_allclose(
                getattr(state, k).numpy(), np.asarray(getattr(want, k)),
                rtol=1e-5, atol=1e-6, err_msg=k)
        assert set(opt) == set(jopt) == set(FIELDS) | (
            {"exposure"} if exposure else set()) | (
            {"bilagrid"} if grid else set())
        for k in opt:
            assert opt[k]["count"] == jopt[k]["count"] == i + 1
            # first moments: (1 - b1) x gradients summed in other
            # orders: 2e-3 relative, or 1e-4 of the group's largest
            for slot in ("mu", "nu"):
                scale = np.abs(jopt[k][slot]).max()
                np.testing.assert_allclose(opt[k][slot], jopt[k][slot],
                                           rtol=2e-3, atol=1e-4 * scale,
                                           err_msg=f"{k} {slot}")
        d = to_numpy(state.densify_state)
        np.testing.assert_array_equal(d["count"],
                                      np.asarray(want.densify_state.count))
        np.testing.assert_allclose(d["grad_accum"],
                                   np.asarray(want.densify_state.grad_accum),
                                   rtol=2e-3, atol=1e-7)


def _port_frames(seed=2, n=40, n_cameras=4, size=48, rcfg=None):
    gt, frames = synthetic_scene(seed, n, n_cameras, size, size, sh_degree=1,
                                 device="cpu")
    with torch.no_grad():
        for f in frames:
            f.image = rasterize(gt, f.camera, rcfg, impl="reference")[
                "rgb"].numpy()
    return gt, frames


def test_exposure_correction_recovers_frame_tints():
    """The port's test_train.py::test_exposure_correction_recovers_frame_
    tints: per-frame tints; with exposure on, post-correction training
    PSNR beats the exposure-off run by 1 dB."""
    rcfg = RenderConfig(ref_gaussian_chunk=64, tile_capacity=128)
    gt, frames = _port_frames(rcfg=rcfg)
    tints = np.array([[1.3, 0.8, 1.0], [0.8, 1.2, 0.9],
                      [1.0, 1.0, 1.3], [0.9, 0.9, 0.7]], np.float32)
    for f, tint in zip(frames, tints):
        f.image = np.clip(f.image * tint[None, None, :], 0.0, 1.0)
    rng = np.random.default_rng(1)

    def init_g():
        return Gaussians.from_points(
            gt.means.numpy() + rng.normal(scale=0.02, size=(40, 3))
            .astype(np.float32), colors=np.full((40, 3), 0.5, np.float32),
            sh_degree=1, init_scale=np.full((40,), 0.05, np.float32),
            device="cpu")

    final = {}
    for exposure in (False, True):
        cfg = tt.TrainConfig(iterations=100, render=rcfg, densify_from=10_000,
                             opacity_reset_interval=10_000, scene_extent=1.0,
                             impl="reference", log_every=25,
                             exposure=exposure, exposure_lr=5e-3)
        trainer = tt.Trainer(cfg, init_g(), frames)
        trainer.run(progress=False)
        final[exposure] = trainer.history[-1]["psnr"]
    assert final[True] > final[False] + 1.0, final
    # the affines moved off identity toward the tints: frame 0's red gain
    # above its green gain
    e0 = trainer.state.exposure[0]
    assert float(e0[0, 0]) > float(e0[1, 1])


def test_checkpoint_carries_exposure_and_grid(tmp_path):
    """A run resumed from its checkpoint after loop step 3 ends where the
    uninterrupted run ends: the Gaussians, the affines, the grids and
    their Adam groups."""
    rcfg = RenderConfig(**RKW)
    gt, frames = _port_frames(seed=5, n=20, n_cameras=3, size=32, rcfg=rcfg)
    init = Gaussians.from_points(gt.means.numpy(), sh_degree=1, device="cpu")
    cfg = tt.TrainConfig(iterations=6, render=rcfg, densify_from=10_000,
                         opacity_reset_interval=10_000, impl="tiled",
                         log_every=100, exposure=True, bilateral_grid=True,
                         bilagrid_shape=(4, 4, 3),
                         checkpoint_dir=str(tmp_path / "ck"),
                         checkpoint_every=3)
    full = tt.Trainer(cfg, init, frames)
    full.run(progress=False)
    resumed = tt.Trainer(dataclasses.replace(cfg, checkpoint_dir=None), init,
                         frames)
    resumed.restore_checkpoint(str(tmp_path / "ck" / "step_4.pt"))
    assert resumed.state.step == 4
    assert resumed.state.exposure.shape == (3, 3, 4)
    assert resumed.state.bilagrid.shape == (3, 4, 4, 3, 12)
    assert set(resumed.state.opt_state) >= {"exposure", "bilagrid"}
    resumed.run(iterations=2, progress=False)
    a, b = to_numpy(resumed.state), to_numpy(full.state)
    for k in ("exposure", "bilagrid"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(a["opt_state"][k]["mu"],
                                      b["opt_state"][k]["mu"], err_msg=k)
    for k in FIELDS:
        np.testing.assert_array_equal(a["gaussians"][k], b["gaussians"][k])
    assert not np.array_equal(b["exposure"], to_numpy(
        tt.identity_exposure(3, device="cpu")))


def _fused_fixture():
    """test_train.py::test_fused_steps_match_unfused_loop's scene: the
    JAX package's synthetic scene, targets and depth maps, carried over."""
    gt, jframes = jsynthetic_scene(seed=3, n_gaussians=40, n_cameras=5,
                                   width=48, height=48, sh_degree=1)
    rcfg = JConfig(tile_capacity=128, max_tiles_per_gaussian=16)
    frames, jframes_d = [], []
    for f in jframes:
        out = jrasterize(gt, f.camera, rcfg, impl="reference")
        img = np.asarray(out["rgb"])
        a = np.asarray(out["alpha"])
        depth = np.where(a > 0.3, np.asarray(out["depth"]) / np.maximum(
            a, 1e-6), 0.0).astype(np.float32)
        f.image, f.depth = img, depth
        jframes_d.append(f)
        frames.append(Frame(camera=camera_from_numpy(
            jax.device_get(f.camera), "cpu"), image=img, depth=depth))
    rng = np.random.default_rng(1)
    pts = (np.asarray(gt.means)
           + rng.normal(scale=0.05, size=(40, 3)).astype(np.float32))
    jinit = JGaussians.from_points(pts, sh_degree=1, capacity=64)
    kw = dict(iterations=25, impl="tiled", log_every=5, densify_from=10,
              densify_until=20, densify_interval=10,
              opacity_reset_interval=10_000, dynamic_pool=False,
              depth_lambda=0.05, scene_extent=1.0)
    return jframes_d, frames, jinit, rcfg, kw


def test_fused_steps_match_unfused_loop():
    """The port's fused loop (F = 5: chunks end at the densify rounds of
    steps 10 and 20, depth supervision on) is step for step its unfused
    loop, at the JAX test's tolerances: every logged loss (rtol 1e-5,
    atol 1e-6), the means (rtol 1e-5, atol 1e-6), the opacities (1e-5)."""
    _, frames, jinit, _, kw = _fused_fixture()
    cfg = tt.TrainConfig(render=RenderConfig(tile_capacity=128,
                                             max_tiles_per_gaussian=16), **kw)

    def train(c):
        tr = tt.Trainer(c, gaussians_from_numpy(jax.device_get(jinit), "cpu"),
                        frames)
        tr.run(progress=False)
        return tr

    tr0 = train(cfg)
    tr1 = train(dataclasses.replace(cfg, fused_steps=5))
    assert tr0._fused_steps_fn is None and tr1._fused_steps_fn is not None
    assert [m["step"] for m in tr1.history] == [m["step"] for m in
                                                tr0.history]
    for m0, m1 in zip(tr0.history, tr1.history):
        np.testing.assert_allclose(m1["loss"], m0["loss"], rtol=1e-5,
                                   atol=1e-6)
    g0, g1 = tr0.state.gaussians, tr1.state.gaussians
    assert int(g1.num_alive) == int(g0.num_alive) > 40      # densified
    np.testing.assert_allclose(g1.means.numpy(), g0.means.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g1.logit_opacities.numpy(),
                               g0.logit_opacities.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert tr1.state.step == tr0.state.step == 25


def test_fused_steps_match_jax_before_the_first_densify():
    """Ten steps in two chunks of five on the same fixture, the port
    against the JAX package's fused run (its PRNG draws nothing before
    the first densify): logged losses, means and opacities at the JAX
    test's tolerances."""
    jframes, frames, jinit, rcfg, kw = _fused_fixture()
    kw = {**kw, "iterations": 10, "fused_steps": 5}
    jtr = jt.Trainer(jt.TrainConfig(render=rcfg, **kw),
                     jax.tree_util.tree_map(jnp.copy, jinit), jframes)
    jtr.run(progress=False)
    tr = tt.Trainer(tt.TrainConfig(render=RenderConfig(
        tile_capacity=128, max_tiles_per_gaussian=16), **kw),
        gaussians_from_numpy(jax.device_get(jinit), "cpu"), frames)
    tr.run(progress=False)
    assert [m["step"] for m in tr.history] == [m["step"] for m in
                                               jtr.history] == [0, 5]
    for m, jm in zip(tr.history, jtr.history):
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5,
                                   atol=1e-6)
    jg = jax.device_get(jtr.state.gaussians)
    np.testing.assert_allclose(tr.state.gaussians.means.numpy(),
                               np.asarray(jg.means), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tr.state.gaussians.logit_opacities.numpy(),
                               np.asarray(jg.logit_opacities), rtol=1e-5,
                               atol=1e-5)


def test_fused_steps_need_one_resolution_and_device_targets(monkeypatch):
    """_fused_steps_fn is None when the frames' resolutions differ, and a
    run with host-streamed targets never calls it (and still trains as
    the unfused loop does)."""
    rcfg = RenderConfig(**RKW)
    gt, frames = _port_frames(seed=4, n=20, n_cameras=3, size=32, rcfg=rcfg)
    init = Gaussians.from_points(gt.means.numpy(), sh_degree=1, device="cpu")
    cfg = tt.TrainConfig(iterations=4, render=rcfg, densify_from=10_000,
                         opacity_reset_interval=10_000, impl="tiled",
                         log_every=1, fused_steps=2)
    odd = Frame(camera=frames[0].camera.resized(24, 32),
                image=np.zeros((32, 24, 3), np.float32))
    assert tt.Trainer(cfg, init, frames + [odd])._fused_steps_fn is None
    host = tt.Trainer(dataclasses.replace(cfg, host_data=True), init, frames)
    assert host._fused_steps_fn is not None

    def refuse(*a, **k):
        raise AssertionError("fused steps called in host-streaming mode")

    monkeypatch.setattr(host, "_fused_steps_fn", refuse)
    host.run(progress=False)
    plain = tt.Trainer(dataclasses.replace(cfg, fused_steps=0), init, frames)
    plain.run(progress=False)
    assert [m["loss"] for m in host.history] == [m["loss"] for m in
                                                 plain.history]


def test_cli_train_exposure_and_bilateral_grid_cpu(tmp_path):
    out = tmp_path / "run"
    cli_train.main(["--synthetic", "40", "--iterations", "3", "--capacity",
                    "64", "--sh-degree", "1", "--device", "cpu",
                    "--exposure", "--bilateral-grid", "--output", str(out)])
    summary = json.loads((out / "train_summary.json").read_text())
    assert np.isfinite(summary["psnr"]) and summary["n_alive"] == 40
    assert (out / "scene.ply").is_file()
