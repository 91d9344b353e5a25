"""The flagship reconstruction tool (tools/flagship.py) against the JAX
package's scripts/train_synthetic_flagship.py: the scene, its targets and
cameras, the initial points, the TrainConfig and three train steps from
the script's own initial pool, and the run's result.json.

The script is loaded from its file and its main() is run at a small size
through its environment knobs, with the JAX Trainer replaced by a
recorder that stops the run once it has been handed its arguments."""

import dataclasses
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from robosimgs_tpu.render import mesh_raster as jmesh_raster
from robosimgs_tpu.train import trainer as jt

from robosimgs_tpu_torch.core.convert import (camera_from_numpy,
                                              gaussians_from_numpy,
                                              opt_state_from_numpy, to_numpy)
from robosimgs_tpu_torch.train.data import Frame
from robosimgs_tpu_torch.train.trainer import Trainer
from robosimgs_tpu_torch.tools import flagship

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "train_synthetic_flagship.py")
RES, VIEWS = 64, 4
# pixels whose mesh coverage may differ: centers within f32 rounding of
# a triangle edge (tests/test_torch_mesh_raster.py)
EDGE_FRAC = 1e-3
KNOBS = dict(SYN_RES=RES, SYN_VIEWS=VIEWS, SYN_HOLDOUT=1, SYN_INIT=500,
             SYN_CAPACITY=1024, SYN_ITERS=3)
RESULT_KEYS = {"train_psnr", "eval_psnr", "iters_per_sec", "iterations",
               "views", "capacity", "init_points", "final_alive",
               "resolution", "history"}


class _Stop(Exception):
    pass


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_script(path: str, name: str):
    """The script at `path` as a module (sys.path as it was afterwards)."""
    saved = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


@pytest.fixture(scope="module")
def script():
    return load_script(SCRIPT, "train_synthetic_flagship")


@pytest.fixture(scope="module")
def jax_scene(script):
    """The script's build_scene(11, 4, 64, with_depth=True), and the face
    colours it handed the mesh rasterizer."""
    seen = []
    real = jmesh_raster.rasterize_mesh

    def recording(*a, **kw):
        seen.append(np.asarray(kw["face_colors"]))
        return real(*a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(jmesh_raster, "rasterize_mesh", recording)
    try:
        scene, frames = script.build_scene(11, VIEWS, RES, with_depth=True)
    finally:
        mp.undo()
    return scene, frames, seen[0]


@pytest.fixture(scope="module")
def jax_main(script, jax_scene, tmp_path_factory):
    """The script's main() at the KNOBS size: the (cfg, init, train
    frames, eval frames) it hands the Trainer."""
    got = {}

    def recorder(cfg, init, train_frames, eval_frames=None):
        got.update(cfg=cfg, init=init, train=train_frames, eval=eval_frames)
        raise _Stop

    mp = pytest.MonkeyPatch()
    for k, v in KNOBS.items():
        mp.setenv(k, str(v))
    mp.setattr(jt, "Trainer", recorder)
    mp.setattr(script, "build_scene", lambda *a, **kw: jax_scene[:2])
    mp.setattr(sys, "argv", ["x", str(tmp_path_factory.mktemp("jflag"))])
    try:
        with pytest.raises(_Stop):
            script.main()
    finally:
        mp.undo()
    return got


def _cam_close(cam, jcam):
    assert (cam.width, cam.height) == (jcam.width, jcam.height)
    for k in ("fx", "fy", "cx", "cy", "c2w"):
        np.testing.assert_allclose(getattr(cam, k).numpy(),
                                   np.asarray(getattr(jcam, k)), atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("with_depth", [False, True])
def test_build_scene_matches_script(jax_scene, with_depth):
    jscene, jframes, jcolors = jax_scene
    scene, colors = flagship.scene_mesh(11)
    np.testing.assert_array_equal(scene.vertices, jscene.vertices)
    np.testing.assert_array_equal(scene.faces, jscene.faces)
    np.testing.assert_array_equal(colors, jcolors)
    _, frames = flagship.build_scene(11, VIEWS, RES, with_depth=with_depth,
                                     device="cpu")
    assert len(frames) == len(jframes) == VIEWS
    for f, jf in zip(frames, jframes):
        _cam_close(f.camera, jf.camera)
        assert f.image.shape == (RES, RES, 3) and f.image.dtype == np.float32
        off = (np.abs(f.image - jf.image) > 1e-5).any(-1)
        assert off.mean() <= EDGE_FRAC, int(off.sum())
        assert (f.image == 1.0).all(-1).any()        # white where empty
        if not with_depth:
            assert f.depth is None
            continue
        hit, jhit = f.depth > 0, jf.depth > 0
        assert (hit != jhit).mean() <= EDGE_FRAC
        both = hit & jhit
        off = np.abs(f.depth - jf.depth)[both] > 1e-5 * jf.depth[both]
        assert off.mean() <= EDGE_FRAC, int(off.sum())
        assert (f.depth[~hit] == 0.0).all() and hit.mean() > 0.3


def test_init_points_match_script(jax_scene, jax_main):
    n = KNOBS["SYN_INIT"]
    pts = flagship.init_points(jax_scene[0], n)
    jinit = jax.device_get(jax_main["init"])
    np.testing.assert_array_equal(pts, np.asarray(jinit.means)[:n])
    assert jinit.means.shape[0] == KNOBS["SYN_CAPACITY"]
    scene, _ = flagship.scene_mesh(11)
    np.testing.assert_array_equal(flagship.init_points(scene, n), pts)


def assert_config_equal(cfg, jcfg, name=""):
    """Every field of the JAX config (nested configs field by field)
    equal in the port's; the port's own fields are not compared."""
    got, want = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)

    def walk(a, b, path):
        for k, v in b.items():
            assert k in a, (name, path + k)
            if isinstance(v, dict):
                walk(a[k], v, path + k + ".")
            else:
                assert a[k] == v, (name, path + k, a[k], v)

    walk(got, want, "")


def test_train_config_matches_script(jax_main):
    cfg = flagship.train_config(KNOBS["SYN_ITERS"])
    assert_config_equal(cfg, jax_main["cfg"])
    assert cfg.impl == "auto" and cfg.dynamic_pool is False
    assert cfg.render.tile_capacity == 2048


def test_three_steps_match_jax_trainer(jax_main):
    """Three steps of the flagship TrainConfig at 64x64 from the script's
    initial pool carried across, on the script's targets: the logged
    loss and PSNR, every parameter, the Adam moments and the densify
    statistics, at tests/test_torch_trainer.py's tolerances. As there,
    the splats are made anisotropic and rotated first (on both sides):
    an isotropic splat's rotation has no gradient, and Adam would scale
    its f32 noise up to +-lr."""
    jinit = jax_main["init"]
    cap = jinit.means.shape[0]
    rng = np.random.default_rng(2)
    quats = rng.normal(size=(cap, 4)).astype(np.float32) * 0.3
    quats[:, 0] += 1.0
    ls = np.asarray(jinit.log_scales) + np.log(
        rng.uniform(0.5, 2.0, (cap, 3))).astype(np.float32)
    jinit = jinit.replace(quats=jax.numpy.asarray(quats),
                          log_scales=jax.numpy.asarray(ls))
    jtr = jt.Trainer(jax_main["cfg"], jinit, jax_main["train"],
                     eval_frames=jax_main["eval"])
    jtr.run(iterations=3, progress=False)
    init = gaussians_from_numpy(jax.device_get(jinit), "cpu")
    frames = [Frame(camera=camera_from_numpy(jax.device_get(f.camera), "cpu"),
                    image=np.asarray(f.image)) for f in jax_main["train"]]
    tr = Trainer(flagship.train_config(KNOBS["SYN_ITERS"]), init, frames)
    tr.run(iterations=3, progress=False)
    assert tr.impl == jtr.impl == "reference"
    (m,), (jm,) = tr.history, jtr.history
    for k in ("loss", "psnr"):
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, err_msg=k)
    assert m["n_alive"] == jm["n_alive"] == KNOBS["SYN_INIT"]
    want = jax.device_get(jtr.state)
    assert tr.state.step == int(want.step) == 3
    g = to_numpy(tr.state.gaussians)
    for k in ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
              "sh_rest"):
        np.testing.assert_allclose(g[k], np.asarray(getattr(want.gaussians,
                                                            k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    opt = to_numpy(tr.state.opt_state)
    jopt = to_numpy(opt_state_from_numpy(want.opt_state, "cpu"))
    for k in opt:
        assert opt[k]["count"] == jopt[k]["count"] == 3
        scale = np.abs(jopt[k]["mu"]).max()
        np.testing.assert_allclose(opt[k]["mu"], jopt[k]["mu"], rtol=2e-3,
                                   atol=1e-4 * scale, err_msg=k)
    d = to_numpy(tr.state.densify_state)
    np.testing.assert_array_equal(d["count"],
                                  np.asarray(want.densify_state.count))
    np.testing.assert_allclose(d["grad_accum"],
                               np.asarray(want.densify_state.grad_accum),
                               rtol=2e-3, atol=1e-7)


def test_run_writes_result_json(tmp_path):
    out = tmp_path / "flag"
    res = flagship.run(str(out), res=32, iters=3, capacity=2048, n_init=300,
                       n_views=4, n_hold=1, device="cpu", progress=False)
    got = json.loads((out / "result.json").read_text())
    assert set(got) == RESULT_KEYS
    assert got["iterations"] == 3 and got["views"] == 3
    assert got["resolution"] == [32, 32] and got["init_points"] == 300
    assert got["final_alive"] == 300 and np.isfinite(got["eval_psnr"])
    assert [h["step"] for h in got["history"]] == [0]
    assert "overflow" in got["history"][0]
    assert res["capacity"] == 2048
    for name in ("render_eval", "target_eval", "render_train0",
                 "target_train0"):
        assert (out / f"{name}.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
