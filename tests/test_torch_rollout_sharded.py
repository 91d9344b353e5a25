"""Camera-sharded rollouts: the port's render_rollout(camera_mesh=) on 2
spawned gloo ranks on the CPU (tools/dist_run.py) against the unsharded
port (bit-equal) and against the JAX package's
render_rollout(camera_mesh=make_mesh(2, 1)) on jax.devices()[:2] (the
rollout tolerance of tests/test_torch_scenegen.py: 1e-5, one uint8
level, mesh-edge pixels excepted); cli.render_rollout --shard-cameras
on one rank and on three (two render, one waits) writing the PNGs the
unsharded CLI writes."""

import glob

import jax
import numpy as np
import pytest
import torch

from robosimgs_tpu.parallel.mesh import make_mesh as jmake_mesh
from robosimgs_tpu.render.config import RenderConfig as JConfig
from robosimgs_tpu.scenegen import rollout as jrollout
from robosimgs_tpu.train import io_ply as jio
from tests.test_torch_scenegen import (BOX_URDF, CFG, _assert_frames_close,
                                       _rollout_inputs, box_mesh)

from robosimgs_tpu_torch.cli import render_rollout as cli_rollout
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.scenegen import rollout
from robosimgs_tpu_torch.tools import dist_run
from robosimgs_tpu_torch.utils import meshio
from robosimgs_tpu_torch.utils.imresize import read_png_rgb


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def urdf(tmp_path_factory):
    d = tmp_path_factory.mktemp("urdf")
    meshio.save_mesh(str(d / "body.glb"), box_mesh())
    meshio.save_mesh(str(d / "lid.glb"), box_mesh((0.5, 0.5, 0.05)))
    (d / "robot.urdf").write_text(BOX_URDF)
    return str(d / "robot.urdf")


@pytest.fixture(scope="module")
def inputs(urdf):
    (bg, obj, cams), jax_side = _rollout_inputs(urdf)
    traj = rollout.open_close_trajectory(obj.model, 3)
    return bg, obj, cams, traj, jax_side


@pytest.fixture(scope="module")
def sharded(inputs, urdf):
    bg, _, cams, traj, _ = inputs
    kw = dict(mesh_shape=(2, 1), background=bg, urdfs=[urdf],
              trajectory=traj, cameras=cams, cfg=RenderConfig(**CFG))
    cases = [("reference", dist_run.rollout, dict(impl="reference", **kw)),
             ("tiled_u8", dist_run.rollout,
              dict(impl="tiled", as_uint8=True, **kw))]
    return dist_run.run_ranks(dist_run.run_cases, 2, args=(cases,))


def test_sharded_rollout_bit_equal_to_unsharded(inputs, sharded):
    bg, obj, cams, traj, _ = inputs
    for impl, as_uint8, name in (("reference", False, "reference"),
                                 ("tiled", True, "tiled_u8")):
        want = rollout.render_rollout(bg, [obj], traj, cams,
                                      cfg=RenderConfig(**CFG), impl=impl,
                                      as_uint8=as_uint8)
        for res in sharded:
            got = res[name]["frames"]
            assert got.shape == want.shape == (3, 2, 32, 48, 3)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_sharded_rollout_matches_jax_camera_mesh(inputs, sharded):
    _, _, _, traj, (jbg, jobj, jcams) = inputs
    want = jrollout.render_rollout(
        jbg, [jobj], traj, jcams, cfg=JConfig(**CFG), impl="reference",
        camera_mesh=jmake_mesh(2, 1, devices=jax.devices()[:2]))
    for res in sharded:
        _assert_frames_close(res["reference"]["frames"], np.asarray(want),
                             1e-5)


def _frames(out):
    files = sorted(glob.glob(str(out / "frame_*.png")))
    return files, [read_png_rgb(f) for f in files]


def test_cli_shard_cameras_one_and_three_ranks(tmp_path, urdf, capsys):
    jg = jax.device_get(_rollout_inputs(urdf)[1][0])
    scene = str(tmp_path / "scene.ply")
    jio.save_ply(scene, jg)
    argv = ["--scene", scene, "--urdf", urdf, "--steps", "2",
            "--n-cameras", "2", "--width", "48", "--height", "32",
            "--device", "cpu", "--output"]
    cli_rollout.main(argv + [str(tmp_path / "plain")])
    cli_rollout.main(argv + [str(tmp_path / "one"), "--shard-cameras"])
    assert "sharding 2 cameras over 1 devices" in capsys.readouterr().out
    dist_run.run_ranks(dist_run.cli_render_rollout, 3, backend=None,
                       args=(argv + [str(tmp_path / "three"),
                                     "--shard-cameras"],))
    names, want = _frames(tmp_path / "plain")
    assert len(want) == 4                           # 2 steps x 2 cameras
    for run in ("one", "three"):
        got_names, got = _frames(tmp_path / run)
        assert [n.rsplit("/", 1)[1] for n in got_names] == \
            [n.rsplit("/", 1)[1] for n in names]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
