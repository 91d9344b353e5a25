"""Trainer parity and behaviour: train steps of the port's
`make_train_step(cfg, "tiled")` against the JAX package's from one
TrainState carried across with core/convert.py; a port-only convergence
run; checkpoint and resume; the train and render CLIs on the CPU."""

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
from robosimgs_tpu.train.data import synthetic_scene as jsynthetic_scene
from robosimgs_tpu.train.densify import DensifyState as JDensifyState
from robosimgs_tpu.train.optim import float_params as jfloat_params
from robosimgs_tpu.train.optim import make_optimizer as jmake_optimizer

from robosimgs_tpu_torch.cli import render as cli_render
from robosimgs_tpu_torch.cli import train as cli_train
from robosimgs_tpu_torch.core.convert import (camera_from_numpy,
                                              opt_state_from_numpy,
                                              to_numpy, train_state_from_numpy)
from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.core.types import Gaussians
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.rasterize import rasterize
from robosimgs_tpu_torch.train import trainer as tt
from robosimgs_tpu_torch.train.data import Frame, synthetic_scene

RKW = dict(tile_capacity=128, max_tiles_per_gaussian=16, ref_gaussian_chunk=64)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_steps_match_jax():
    """Three tiled train steps (SH warm-up every step, the scale
    regularizer on) from one converted state: loss, PSNR, every
    parameter, the Adam state and the densify statistics."""
    W = H = 32
    gt, jframes = jsynthetic_scene(seed=3, n_gaussians=40, n_cameras=3,
                                   width=W, height=H, sh_degree=1)
    targets = [np.array(jrasterize(gt, f.camera, JConfig(**RKW),
                                   impl="reference")["rgb"]) for f in jframes]
    rng = np.random.default_rng(1)
    jg = JGaussians.from_points(
        np.asarray(gt.means)[:40] + rng.normal(scale=0.05, size=(40, 3))
        .astype(np.float32), colors=np.full((40, 3), 0.5, np.float32),
        sh_degree=1, capacity=48, init_scale=np.full((40,), 0.08, np.float32))
    # anisotropic, rotated splats: the rotation of an isotropic one has
    # no gradient, and Adam would scale its f32 noise up to +-lr
    quats = rng.normal(size=(48, 4)).astype(np.float32) * 0.3
    quats[:, 0] += 1.0
    ls = np.log(0.08 * rng.uniform(0.4, 2.0, (48, 3))).astype(np.float32)
    jg = jg.replace(quats=jnp.asarray(quats), log_scales=jnp.asarray(ls))
    kw = dict(render=RenderConfig(**RKW), sh_warmup_every=1,
              scale_reg_lambda=0.01, scale_reg_max_ratio=1.5)
    jcfg = jt.TrainConfig(**{**kw, "render": JConfig(**RKW)})
    jstate = jt.TrainState(
        gaussians=jg, opt_state=jmake_optimizer().init(jfloat_params(jg)),
        densify_state=JDensifyState.zero(48), step=jnp.int32(0),
        key=jax.random.PRNGKey(0))
    state = train_state_from_numpy(jax.device_get(jstate), "cpu")
    jstep = jt.make_train_step(jcfg, "tiled")
    step = tt.make_train_step(tt.TrainConfig(**kw), "tiled")
    cams = [camera_from_numpy(jax.device_get(f.camera), "cpu")
            for f in jframes]
    for i in range(3):
        jstate, jm = jstep(jstate, jframes[i].camera, jnp.asarray(targets[i]))
        state, m = step(state, cams[i], torch.from_numpy(targets[i]))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["psnr"]), float(jm["psnr"]),
                                   rtol=1e-5)
        assert int(m["n_alive"]) == int(jm["n_alive"]) == 40
        assert int(m["overflow"]) == int(jm["overflow"]) == 0
        want = jax.device_get(jstate)
        assert state.step == int(want.step) == i + 1
        g, jgw = to_numpy(state.gaussians), want.gaussians
        # an Adam step moves each coordinate by about lr, so parameters
        # agree to ~1e-3 of the lr wherever the gradients agree to 1e-3
        for k in ("means", "quats", "log_scales", "logit_opacities",
                  "sh_dc", "sh_rest"):
            np.testing.assert_allclose(g[k], np.asarray(getattr(jgw, k)),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        opt, jopt = to_numpy(state.opt_state), to_numpy(
            opt_state_from_numpy(want.opt_state, "cpu"))
        for k in opt:
            assert opt[k]["count"] == jopt[k]["count"] == i + 1
            # the first moments are (1 - b1) x gradients summed in other
            # orders: 2e-3 relative, or 1e-4 of the group's largest
            scale = np.abs(jopt[k]["mu"]).max()
            np.testing.assert_allclose(opt[k]["mu"], jopt[k]["mu"],
                                       rtol=2e-3, atol=1e-4 * scale,
                                       err_msg=k)
        d = to_numpy(state.densify_state)
        np.testing.assert_array_equal(d["count"],
                                      np.asarray(want.densify_state.count))
        np.testing.assert_array_equal(d["max_radii"],
                                      np.asarray(want.densify_state.max_radii))
        np.testing.assert_allclose(d["grad_accum"],
                                   np.asarray(want.densify_state.grad_accum),
                                   rtol=2e-3, atol=1e-7)
    assert d["grad_accum"].max() > 0


def _frames_and_init(seed=0, n=40, n_cameras=6, size=48, cfg=None):
    gt, frames = synthetic_scene(seed, n, n_cameras, size, size, sh_degree=1,
                                 device="cpu")
    with torch.no_grad():
        for f in frames:
            f.image = rasterize(gt, f.camera, cfg.render,
                                impl="reference")["rgb"].numpy()
    rng = np.random.default_rng(1)
    init = Gaussians.from_points(
        gt.means.numpy() + rng.normal(scale=0.02, size=(n, 3))
        .astype(np.float32), colors=np.full((n, 3), 0.5, np.float32),
        sh_degree=1, device="cpu")
    return frames, init


@pytest.mark.parametrize("impl", ["tiled", "reference"])
def test_training_converges_synthetic(impl):
    """The counterpart of test_train.py::test_training_converges_synthetic
    on the port: PSNR rises by > 3 dB, the loss falls."""
    cfg = tt.TrainConfig(iterations=120, render=RenderConfig(**RKW),
                         densify_from=10_000, opacity_reset_interval=10_000,
                         impl=impl, log_every=40)
    frames, init = _frames_and_init(cfg=cfg)
    trainer = tt.Trainer(cfg, init, frames)
    assert trainer.impl == impl
    psnr0 = trainer.eval_psnr()
    trainer.run(progress=False)
    psnr1 = trainer.eval_psnr()
    assert psnr1 > psnr0 + 3.0, f"psnr {psnr0:.2f} -> {psnr1:.2f}"
    assert trainer.history[-1]["loss"] < trainer.history[0]["loss"]
    m = trainer.eval_metrics()
    assert set(m) == {"psnr", "ssim"} and 0.0 < m["ssim"] <= 1.0


def test_densify_and_pool_resize_in_run():
    """A run that crosses densify rounds, an opacity reset and pool
    resizes (dynamic_pool) keeps training and shrinks the pool."""
    cfg = tt.TrainConfig(iterations=40, render=RenderConfig(**RKW),
                         densify_from=10, densify_until=30,
                         densify_interval=10, opacity_reset_interval=20,
                         impl="tiled", log_every=10, pool_bucket=16,
                         densify=tt.DensifyConfig(grad_threshold=1e-5))
    frames, init = _frames_and_init(seed=4, n=30, n_cameras=4, size=32,
                                    cfg=cfg)
    init = Gaussians.from_points(init.means.numpy(), sh_degree=1,
                                 capacity=512, device="cpu")
    tr = tt.Trainer(cfg, init, frames)
    tr.run(progress=False)
    assert tr.state.gaussians.capacity < 512
    assert int(tr.state.gaussians.num_alive) > 30          # densified
    assert int(tr.state.opt_state["logit_opacities"].count) == 19
    assert all(np.isfinite(h["loss"]) for h in tr.history)


def test_checkpoint_and_resume(tmp_path):
    """A run resumed from the checkpoint written after loop step 5 (state
    step 6) continues exactly as the uninterrupted run (same data order,
    optimizer state and generator)."""
    cfg = tt.TrainConfig(iterations=10, render=RenderConfig(**RKW),
                         densify_from=10_000, opacity_reset_interval=10_000,
                         impl="tiled", log_every=100,
                         checkpoint_dir=str(tmp_path / "ck"),
                         checkpoint_every=5)
    frames, init = _frames_and_init(seed=2, n=20, n_cameras=3, size=32,
                                    cfg=cfg)
    full = tt.Trainer(cfg, init, frames)
    full.run(progress=False)
    assert full.state.step == 10
    assert [p.name for p in (tmp_path / "ck").iterdir()] == ["step_6.pt"]
    resumed = tt.Trainer(dataclasses.replace(cfg, checkpoint_dir=None), init,
                         frames)
    resumed.restore_checkpoint(str(tmp_path / "ck" / "step_6.pt"))
    assert resumed.state.step == 6
    resumed.run(iterations=4, progress=False)
    for k, v in to_numpy(resumed.state.gaussians).items():
        np.testing.assert_array_equal(
            v, to_numpy(full.state.gaussians)[k], err_msg=k)
    latest = tt.Trainer(cfg, init, frames)
    assert latest.resume_latest() and latest.state.step == 6
    none = tt.Trainer(dataclasses.replace(cfg, checkpoint_dir=str(tmp_path)),
                      init, frames)
    assert not none.resume_latest()


def test_unported_options_raise():
    """The options that raised before they were ported (exposure, the
    bilateral grid, fused_steps) now build a Trainer with their state;
    the reference impl still refuses absgrad."""
    g = Gaussians.random(torch.Generator().manual_seed(0), 4, sh_degree=0,
                         device="cpu")
    frames = [Frame(camera=Camera.look_at([4, 0, 0], [0, 0, 0], [0, 0, 1],
                                          60.0, 8, 8, device="cpu"))] * 2
    tr = tt.Trainer(tt.TrainConfig(exposure=True), g, frames)
    assert tr.state.exposure.shape == (2, 3, 4) and "exposure" in \
        tr.state.opt_state
    tr = tt.Trainer(tt.TrainConfig(bilateral_grid=True), g, frames)
    assert tr.state.bilagrid.shape == (2, 8, 8, 4, 12) and "bilagrid" in \
        tr.state.opt_state
    assert tt.Trainer(tt.TrainConfig(fused_steps=4), g,
                      frames)._fused_steps_fn is not None
    with pytest.raises(ValueError, match="absgrad"):
        tt.make_train_step(tt.TrainConfig(render=RenderConfig(absgrad=True)),
                           "reference")
    e = tt.identity_exposure(2, device="cpu")
    assert e.shape == (2, 3, 4) and torch.equal(e[1, :, :3], torch.eye(3))


def test_cli_train_and_render_cpu(tmp_path):
    out = tmp_path / "run"
    cli_train.main(["--synthetic", "40", "--iterations", "3", "--capacity",
                    "64", "--sh-degree", "1", "--device", "cpu",
                    "--output", str(out)])
    summary = json.loads((out / "train_summary.json").read_text())
    assert np.isfinite(summary["psnr"]) and summary["n_alive"] == 40
    assert summary["history"][0]["step"] == 0
    assert (out / "scene.ply").is_file()
    # --exposure and --bilateral-grid reach TrainConfig
    # (test_torch_train_extras.py trains with both)
    args = cli_train.build_parser().parse_args(
        ["--output", str(out), "--exposure", "--bilateral-grid"])
    assert args.exposure and args.bilateral_grid

    # render the trained scene from a transforms.json's cameras
    c2w = np.eye(4)
    c2w[:3, 3] = [0.0, -4.0, 0.5]
    c2w[:3, :3] = [[1, 0, 0], [0, 0, -1], [0, 1, 0]]   # OpenGL, looking +y
    meta = {"fl_x": 30.0, "fl_y": 30.0, "cx": 20.0, "cy": 16.0, "w": 40,
            "h": 32, "frames": [{"transform_matrix": c2w.tolist()},
                                {"transform_matrix": c2w.tolist()}]}
    (tmp_path / "transforms.json").write_text(json.dumps(meta))
    views = tmp_path / "views"
    cli_render.main([str(out / "scene.ply"), "--output", str(views),
                     "--transforms", str(tmp_path / "transforms.json"),
                     "--device", "cpu", "--background", "0", "0", "0"])
    from PIL import Image
    for i in range(2):
        img = np.asarray(Image.open(views / f"view_{i:04d}.png"))
        assert img.shape == (32, 40, 3) and img.max() > 0
