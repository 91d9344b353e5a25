"""The 2-DOF policy tool (tools/policy_multidof.py) against the JAX
package's scripts/train_policy_multidof.py: the object it writes, the
expert's draws, the rendered frames and the run's results.json.

The script's main() runs at 2 episodes of 4 steps (its two constants
edited in its source) with render_rollout replaced by a recorder and
the PolicyTrainer by a stop: its draws land in its dataset.npz and its
object in its output directory; its background comes across by
core/convert."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from robosimgs_tpu.policy import trainer as jpt
from robosimgs_tpu.scenegen import rollout as jrollout
from robosimgs_tpu.utils import meshio as jmeshio

from robosimgs_tpu_torch.core.convert import gaussians_from_numpy
from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.tools import policy_multidof as pm
from robosimgs_tpu_torch.utils.meshio import load_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "train_policy_multidof.py")
N_EPS, EP_LEN = 2, 4
# tests/test_torch_scenegen.py's rollout tolerance: every pixel within
# 1e-5 but for at most EDGE_FRAC of them (mesh edges, FMA contraction)
EDGE_FRAC = 1e-3
RESULT_KEYS = {"object", "dataset", "training", "closed_loop"}


class _Stop(Exception):
    pass


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The script's main() at N_EPS x EP_LEN: its output directory and
    the arguments of every render_rollout call."""
    with open(SCRIPT) as fh:
        src = fh.read()
    assert src.count("n_eps, ep_len = 56, 36") == 1
    src = src.replace("n_eps, ep_len = 56, 36",
                      f"n_eps, ep_len = {N_EPS}, {EP_LEN}")
    out = str(tmp_path_factory.mktemp("jpm"))
    calls = []

    def recorder(bg, objects, traj, cams, cfg, impl):
        calls.append(dict(bg=bg, objects=objects, traj=traj, cams=cams,
                          cfg=cfg, impl=impl))
        return np.zeros((traj.shape[0], len(cams), 64, 64, 3), np.float32)

    def stop(*a, **kw):
        raise _Stop

    saved = list(sys.path)
    mp = pytest.MonkeyPatch()
    mp.setattr(jrollout, "render_rollout", recorder)
    mp.setattr(jpt, "PolicyTrainer", stop)
    mp.setattr(sys, "argv", ["x", out])
    try:
        mod = {"__name__": "train_policy_multidof", "__file__": SCRIPT}
        exec(compile(src, SCRIPT, "exec"), mod)
        with pytest.raises(_Stop):
            mod["main"]()
    finally:
        mp.undo()
        sys.path[:] = saved
    assert len(calls) == N_EPS
    return out, calls


def test_object_matches_script(jax_run, tmp_path):
    """The URDF and GLBs the tool writes: the script's URDF, the same
    meshes, and forward kinematics (posed link meshes) equal to JAX's at
    three joint vectors."""
    jout, _ = jax_run
    obj = pm.write_object(str(tmp_path))
    assert (tmp_path / "robot.urdf").read_text() == open(
        os.path.join(jout, "robot.urdf")).read()
    for name in ("body.glb", "lid.glb", "flap.glb"):
        m = load_mesh(str(tmp_path / name))
        jm = jmeshio.load_mesh(os.path.join(jout, name))
        np.testing.assert_array_equal(m.vertices, jm.vertices, err_msg=name)
        np.testing.assert_array_equal(m.faces, jm.faces, err_msg=name)
    jobj = jrollout.ArticulatedObject.from_urdf(
        os.path.join(jout, "robot.urdf"))
    assert obj.model.dof == jobj.model.dof == 2
    assert [j.name for j in obj.model.movable] == ["lid_hinge", "flap_hinge"]
    for q in ([0.0, 0.0], [0.7, 0.3], [1.57, 1.2]):
        q = np.asarray(q, np.float32)
        T, jT = obj.model.fk(q), jobj.model.fk(q)
        assert set(T) == set(jT)
        for name in jT:
            np.testing.assert_allclose(T[name], jT[name], atol=1e-6)
        for g, w in zip(obj.posed_meshes(q, device="cpu"),
                        jobj.posed_meshes(q)):
            for x, y in zip(g, w):
                np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                           atol=1e-6)


def _port_inputs(jax_run, tmp_path):
    _, calls = jax_run
    bg = gaussians_from_numpy(jax.device_get(calls[0]["bg"]), "cpu")
    return pm.write_object(str(tmp_path)), bg


def test_draws_match_script(jax_run, tmp_path):
    """States, actions and episode ends bit for bit, and each episode's
    trajectory and camera as the script handed them to the renderer."""
    jout, calls = jax_run
    z = np.load(os.path.join(jout, "dataset.npz"))
    rng = np.random.default_rng(0)
    states, actions, ends, count = [], [], [], 0
    for call in calls:
        traj, eye = pm.draw_episode(rng, EP_LEN)
        np.testing.assert_array_equal(traj[:-1], call["traj"])
        jcam = call["cams"][0]
        cam = Camera.look_at(eye, pm.CENTER, [0, 0, 1], 55.0, pm.RES, pm.RES,
                             device="cpu")
        np.testing.assert_array_equal(cam.c2w.numpy(), np.asarray(jcam.c2w))
        states.append(traj[:-1])
        actions.append(traj[1:])
        count += EP_LEN
        ends.append(count)
    np.testing.assert_array_equal(np.concatenate(states), z["states"])
    np.testing.assert_array_equal(np.concatenate(actions), z["actions"])
    np.testing.assert_array_equal(ends, z["ends"])
    # make_dataset keeps the same draws
    obj, bg = _port_inputs(jax_run, tmp_path)
    ds = pm.make_dataset(obj, bg, np.random.default_rng(0), N_EPS, EP_LEN,
                         progress=False)
    np.testing.assert_array_equal(ds.states, z["states"])
    np.testing.assert_array_equal(ds.actions, z["actions"])
    assert ds.episode_ends == list(z["ends"])
    assert ds.images.shape == (N_EPS * EP_LEN, pm.RES, pm.RES, 3)


def test_background_and_render_config(jax_run):
    """The script's background transform and RenderConfig, applied to the
    port's own draw: 2,000 splats at SH 1, none nearer the object's
    centre than 1.7 radii."""
    _, calls = jax_run
    jbg = jax.device_get(calls[0]["bg"])
    bg = pm.background("cpu")
    assert bg.capacity == np.asarray(jbg.means).shape[0] == 2000
    assert bg.sh_rest.shape == np.asarray(jbg.sh_rest).shape
    for b in (bg.means.numpy(), np.asarray(jbg.means)):
        d = np.linalg.norm(b - pm.CENTER, axis=1)
        assert d.min() >= 1.7 * pm.RADIUS * (1 - 1e-6)
    jcfg = calls[0]["cfg"]
    assert (pm.RENDER.tile_capacity, pm.RENDER.max_tiles_per_gaussian) == (
        jcfg.tile_capacity, jcfg.max_tiles_per_gaussian)


def test_frames_match_jax_render_rollout(jax_run, tmp_path):
    """The first episode's frames, rendered by the tool on the script's
    background carried across, against the JAX render_rollout on the
    script's own arguments."""
    _, calls = jax_run
    c = calls[0]
    want = np.asarray(jrollout.render_rollout(
        c["bg"], c["objects"], c["traj"], c["cams"], cfg=c["cfg"],
        impl=c["impl"]))[:, 0]
    obj, bg = _port_inputs(jax_run, tmp_path)
    got = pm.make_dataset(obj, bg, np.random.default_rng(0), 1, EP_LEN,
                          progress=False).images
    assert got.shape == want.shape == (EP_LEN, pm.RES, pm.RES, 3)
    off = (np.abs(got - want) > 1e-5).any(-1)
    assert off.mean() <= EDGE_FRAC, int(off.sum())
    assert np.abs(got[0] - got[-1]).max() > 1e-2       # the joints move


def test_tiny_run_writes_results_json(tmp_path):
    out = tmp_path / "pm"
    res = pm.run(str(out), n_eps=2, ep_len=12, steps=3, n_eval=1,
                 eval_steps=3, ddim_steps=2, device="cpu", progress=False)
    got = json.loads((out / "results.json").read_text())
    assert set(got) == RESULT_KEYS
    assert got["object"] == {"dof": 2, "targets": pm.TARGETS_Q.tolist()}
    assert got["dataset"] == {"episodes": 2, "ep_len": 12, "res": 64}
    assert set(got["training"]) == {"steps", "loss_first", "loss_last"}
    assert set(got["closed_loop"]) == {"episodes", "steps", "success",
                                       "final_angles", "eval_s"}
    assert got["closed_loop"]["episodes"] == 1
    assert len(got["closed_loop"]["final_angles"][0]) == 2
    assert np.isfinite(got["training"]["loss_last"])
    assert set(res["seconds"]) == {"dataset", "train", "eval"}
    for name in ("ep0_t00.png", "ep0_t11.png", "dataset.npz"):
        assert (out / name).exists(), name
    # a second run reads the cached dataset
    again = pm.run(str(out), n_eps=2, ep_len=12, steps=3, n_eval=1,
                   eval_steps=3, ddim_steps=2, device="cpu", progress=False)
    assert again["training"]["loss_first"] == got["training"]["loss_first"]
