"""Rollout-path parity: the port's meshio, URDF FK, trajectories,
ArticulatedObject, render_rollout, capacity autotuning and rollout CLI
against the JAX package's on the same files and numpy inputs."""

import dataclasses
import glob
import json

import jax
import numpy as np
import pytest
import torch

from robosimgs_tpu.core.camera import Camera as JCamera
from robosimgs_tpu.core.types import Gaussians as JGaussians
from robosimgs_tpu.render.autotune import recommend_capacities as jrecommend
from robosimgs_tpu.render.config import RenderConfig as JConfig
from robosimgs_tpu.scenegen import rollout as jrollout
from robosimgs_tpu.scenegen import trajectory as jtraj
from robosimgs_tpu.scenegen.urdf_fk import URDFModel as JURDFModel
from robosimgs_tpu.train import io_ply as jio
from robosimgs_tpu.utils import meshio as jmeshio

from robosimgs_tpu_torch.cli import render_rollout as cli_rollout
from robosimgs_tpu_torch.core.convert import (camera_from_numpy,
                                              gaussians_from_numpy)
from robosimgs_tpu_torch.render.autotune import recommend_capacities
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.scenegen import rollout, trajectory
from robosimgs_tpu_torch.scenegen.urdf_fk import URDFModel, rpy_to_matrix
from robosimgs_tpu_torch.utils import meshio

BOX_URDF = """<?xml version="1.0"?>
<robot name="testbox">
  <link name="body">
    <visual>
      <geometry><mesh filename="body.glb" scale="1 1 1"/></geometry>
      <material name="m"><color rgba="0.8 0.6 0.4 1.0"/></material>
    </visual>
    <inertial><mass value="0.5"/>
      <inertia ixx="0.01" ixy="0" ixz="0" iyy="0.01" iyz="0" izz="0.01"/>
    </inertial>
  </link>
  <link name="lid">
    <visual>
      <geometry><mesh filename="lid.glb" scale="1 1 1"/></geometry>
      <material name="m2"><color rgba="0.4 0.6 0.8 1.0"/></material>
    </visual>
    <inertial><mass value="0.2"/>
      <inertia ixx="0.01" ixy="0" ixz="0" iyy="0.01" iyz="0" izz="0.01"/>
    </inertial>
  </link>
  <joint name="hinge" type="revolute">
    <parent link="body"/><child link="lid"/>
    <origin xyz="0 0.5 0.2" rpy="0 0 0"/>
    <axis xyz="1 0 0"/>
    <limit lower="0.0" upper="1.57" effort="5" velocity="2"/>
    <dynamics friction="0.5" damping="0.2"/>
  </joint>
</robot>"""

CFG = dict(tile_capacity=128)
# pixels whose mesh coverage may differ: centers within f32 rounding of a
# triangle edge (XLA contracts the edge functions into FMAs, torch
# rounds each product; tests/test_torch_mesh_raster.py counts them)
EDGE_FRAC = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def box_mesh(size=(0.5, 0.5, 0.2)):
    sx, sy, sz = size
    v = np.array([[x, y, z] for x in (-sx, sx) for y in (-sy, sy)
                  for z in (-sz, sz)], np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return meshio.Mesh(vertices=v, faces=f)


@pytest.fixture
def urdf_path(tmp_path):
    meshio.save_mesh(str(tmp_path / "body.glb"), box_mesh())
    meshio.save_mesh(str(tmp_path / "lid.glb"), box_mesh((0.5, 0.5, 0.05)))
    path = tmp_path / "robot.urdf"
    path.write_text(BOX_URDF)
    return str(path)


def _tri_mesh():
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    f = np.array([[0, 1, 2], [0, 1, 3], [1, 2, 3], [0, 2, 3]], np.int32)
    c = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0]], np.float32)
    return v, f, c


def _textured_quad(mod):
    yy, xx = np.mgrid[0:32, 0:32]
    sel = ((xx // 8 + yy // 8) % 2).astype(bool)
    tex = np.where(sel[..., None], np.float32([0, 0, 1]),
                   np.float32([1, 0, 0])).astype(np.float32)
    return mod.Mesh(
        vertices=np.float32([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]]),
        faces=np.int32([[0, 1, 2], [0, 2, 3]]),
        uv=np.float32([[0, 0], [1, 0], [1, 1], [0, 1]]), texture=tex)


def _assert_mesh_equal(a, b):
    for k in ("vertices", "faces", "vertex_colors", "uv", "texture"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("ext", ["glb", "obj", "ply", "textured.glb"])
def test_meshio_round_trips_read_as_jax_reads(tmp_path, ext):
    """Files written by either package read identically in both."""
    if ext == "textured.glb":
        ours, theirs = _textured_quad(meshio), _textured_quad(jmeshio)
    else:
        ours, theirs = meshio.Mesh(*_tri_mesh()), jmeshio.Mesh(*_tri_mesh())
    p_ours, p_theirs = str(tmp_path / f"a.{ext}"), str(tmp_path / f"b.{ext}")
    meshio.save_mesh(p_ours, ours)
    jmeshio.save_mesh(p_theirs, theirs)
    for p in (p_ours, p_theirs):
        _assert_mesh_equal(meshio.load_mesh(p), jmeshio.load_mesh(p))
    back = meshio.load_mesh(p_ours)
    np.testing.assert_array_equal(back.vertices, ours.vertices)
    np.testing.assert_array_equal(back.faces, ours.faces)


def test_meshio_helpers_match_jax():
    v, f, c = _tri_mesh()
    m, jm = meshio.Mesh(v, f, c), jmeshio.Mesh(v, f, c)
    cat = meshio.concatenate([m, m.translated([5, 0, 0])])
    jcat = jmeshio.concatenate([jm, jm.translated([5, 0, 0])])
    _assert_mesh_equal(cat, jcat)
    np.testing.assert_array_equal(m.sample_surface(64, seed=1),
                                  jm.sample_surface(64, seed=1))
    q, jq = _textured_quad(meshio), _textured_quad(jmeshio)
    np.testing.assert_array_equal(q.baked_vertex_colors(),
                                  jq.baked_vertex_colors())
    for a, b in zip(q.sample_surface_colored(32, seed=2),
                    jq.sample_surface_colored(32, seed=2)):
        np.testing.assert_array_equal(a, b)
    uv = np.random.default_rng(0).uniform(-1, 2, (50, 2)).astype(np.float32)
    np.testing.assert_array_equal(meshio.sample_texture(q.texture, uv),
                                  jmeshio.sample_texture(jq.texture, uv))


def test_urdf_parse_fk_validate_match_jax():
    m, jm = URDFModel.parse(BOX_URDF), JURDFModel.parse(BOX_URDF)
    assert (m.root, m.dof, m.name) == (jm.root, jm.dof, jm.name)
    for j, jj in zip(m.joints, jm.joints):
        for f in dataclasses.fields(j):
            np.testing.assert_array_equal(getattr(j, f.name),
                                          getattr(jj, f.name), err_msg=f.name)
    base = np.eye(4, dtype=np.float32)
    base[:3, 3] = [1, 2, 3]
    for q in (0.0, 0.7, np.pi / 2):
        T, jT = m.fk({"hinge": q}, base=base), jm.fk({"hinge": q}, base=base)
        for name in jT:
            np.testing.assert_array_equal(T[name], jT[name])
    np.testing.assert_array_equal(m.clamp(np.array([2.0])),
                                  jm.clamp(np.array([2.0])))
    np.testing.assert_allclose(rpy_to_matrix([0, 0, np.pi / 2]) @ [1, 0, 0],
                               [0, 1, 0], atol=1e-6)
    assert m.validate() == jm.validate() == []
    bad = BOX_URDF.replace('lower="0.0" upper="1.57"', 'lower="2.0" upper="1.0"')
    problems = URDFModel.parse(bad).validate()
    assert problems == JURDFModel.parse(bad).validate()
    assert any("lower" in p for p in problems)


def test_trajectories_match_jax(tmp_path):
    m, jm = URDFModel.parse(BOX_URDF), JURDFModel.parse(BOX_URDF)
    joints = np.array([[0.0], [0.5], [1.0]], np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1, 1))
    poses[2, 0, :3, 3] = [0.1, 0.2, 0.3]
    ours, theirs = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    trajectory.save_trajectory(ours, ["testbox"], joints, base_poses=poses,
                               dofs=[1])
    jtraj.save_trajectory(theirs, ["testbox"], joints, base_poses=poses,
                          dofs=[1])
    assert open(ours).read() == open(theirs).read()
    j2, b2 = trajectory.load_trajectory(ours, [m])
    np.testing.assert_array_equal(j2, joints)
    np.testing.assert_array_equal(b2, poses)
    # held joints, a pose carried forward, a NaN sentinel for the object
    # never listed
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [1.0, 2.0, 3.0]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"objects": ["a", "b"], "steps": [
        {"joints": {"a": [0.1], "b": [0.2]}, "base_poses": {"a": pose.tolist()}},
        {},
        {"joints": {"a": [0.9]}}]}))
    got = trajectory.load_trajectory(str(p), [m, m], ["a", "b"])
    want = jtraj.load_trajectory(str(p), [jm, jm], ["a", "b"])
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    assert np.isnan(got[1][:, 1]).all() and not np.isnan(got[1][:, 0]).any()
    np.testing.assert_array_equal(got[0][:, 0], np.float32([0.1, 0.1, 0.9]))
    p.write_text(json.dumps({"objects": ["testbox"], "steps": [
        {"joints": {"testbox": [0.1, 0.2]}}]}))
    with pytest.raises(ValueError, match="expects 1 joints"):
        trajectory.load_trajectory(str(p), [m])


def test_posed_meshes_match_jax(urdf_path):
    obj = rollout.ArticulatedObject.from_urdf(urdf_path)
    jobj = jrollout.ArticulatedObject.from_urdf(urdf_path)
    assert set(obj.link_meshes) == {"body", "lid"}
    base = np.eye(4, dtype=np.float32)
    base[:3, 3] = [0.2, -0.1, 0.3]
    for q, b in ((np.array([0.5]), None), (np.array([1.2]), base)):
        got = obj.posed_meshes(q, base_pose=b, device="cpu")
        want = jobj.posed_meshes(q, base_pose=b)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_array_equal(rollout.open_close_trajectory(obj.model, 5),
                                  jrollout.open_close_trajectory(jobj.model, 5))


def _rollout_inputs(urdf_path, n=50, w=48, h=32):
    jbg = JGaussians.random(jax.random.PRNGKey(0), n, sh_degree=1, extent=2.0)
    jcams = [JCamera.look_at([3, 0.5, 1.5], [0, 0, 0], [0, 0, 1], 60.0, w, h),
             JCamera.look_at([0.5, 3, 1.5], [0, 0, 0], [0, 0, 1], 60.0, w, h)]
    bg = gaussians_from_numpy(jax.device_get(jbg), "cpu")
    cams = [camera_from_numpy(jax.device_get(c), "cpu") for c in jcams]
    return (bg, rollout.ArticulatedObject.from_urdf(urdf_path), cams), \
        (jbg, jrollout.ArticulatedObject.from_urdf(urdf_path), jcams)


def _assert_frames_close(got, want, tol):
    """Every pixel within tol, but for at most EDGE_FRAC of the pixels."""
    off = (np.abs(got - want) > tol).any(-1)
    assert off.mean() <= EDGE_FRAC, int(off.sum())


@pytest.mark.parametrize("poses", [False, True], ids=["joints", "base_poses"])
def test_render_rollout_matches_jax(urdf_path, poses):
    (bg, obj, cams), (jbg, jobj, jcams) = _rollout_inputs(urdf_path)
    traj = rollout.open_close_trajectory(obj.model, 3)
    base = None
    if poses:   # the object slides; NaN: its resting pose at step 0
        base = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1, 1))
        base[0] = np.nan
        base[2, 0, :3, 3] = [0.0, 0.5, 0.0]
    kw = dict(base_poses=base, impl="reference")
    want = jrollout.render_rollout(jbg, [jobj], traj, jcams,
                                   cfg=JConfig(**CFG), **kw)
    got = rollout.render_rollout(bg, [obj], traj, cams,
                                 cfg=RenderConfig(**CFG), **kw)
    assert got.shape == want.shape == (3, 2, 32, 48, 3)
    _assert_frames_close(got, want, 1e-5)
    assert np.abs(got[0] - got[1]).max() > 1e-3        # the object moves
    # uint8 frames (quantized on the device) within one level of JAX's
    got8 = rollout.render_rollout(bg, [obj], traj, cams, cfg=RenderConfig(**CFG),
                                  as_uint8=True, batch_cameras=True, **kw)
    want8 = jrollout.render_rollout(jbg, [jobj], traj, jcams,
                                    cfg=JConfig(**CFG),
                                    as_uint8=True, **kw)
    assert got8.dtype == np.uint8
    _assert_frames_close(got8.astype(int), want8.astype(int), 1)
    # the tiled path (the compositing kernel's plain version on the CPU)
    tiled = rollout.render_rollout(bg, [obj], traj, cams,
                                   cfg=RenderConfig(**CFG), base_poses=base,
                                   impl="tiled")
    _assert_frames_close(tiled, want, 1e-5)


def test_render_rollout_camera_mesh_not_ported(urdf_path):
    """Camera sharding is ported now (tests/test_torch_rollout_sharded.py
    holds it on two ranks): on a one-rank mesh it renders the unsharded
    frames, and cameras of two resolutions cannot be sharded."""
    import torch.distributed as dist

    from robosimgs_tpu_torch.parallel.mesh import make_mesh
    (bg, obj, cams), _ = _rollout_inputs(urdf_path)
    traj = np.zeros((1, 1), np.float32)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(1, 1, device_type="cpu")
        got = rollout.render_rollout(bg, [obj], traj, cams, camera_mesh=mesh,
                                     cfg=RenderConfig(**CFG))
        np.testing.assert_array_equal(got, rollout.render_rollout(
            bg, [obj], traj, cams, cfg=RenderConfig(**CFG)))
        small = cams[1].resized(24, 16)
        with pytest.raises(ValueError, match="one resolution"):
            rollout.render_rollout(bg, [obj], traj, [cams[0], small],
                                   camera_mesh=mesh)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("gate_db", [None, 60.0])
def test_recommend_capacities_matches_jax(gate_db):
    jg = JGaussians.random(jax.random.PRNGKey(3), 80, sh_degree=1, extent=1.5)
    jcams = [JCamera.look_at([2.5 * np.cos(a), 2.5 * np.sin(a), 1.5],
                             [0, 0, 0.3], [0, 0, 1], 60.0, 48, 32)
             for a in (0.0, np.pi)]
    want = jrecommend(jg, jcams, gate_db=gate_db)
    got = recommend_capacities(
        gaussians_from_numpy(jax.device_get(jg), "cpu"),
        [camera_from_numpy(jax.device_get(c), "cpu") for c in jcams],
        gate_db=gate_db)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_cli_render_rollout_cpu(tmp_path, urdf_path):
    jg = JGaussians.random(jax.random.PRNGKey(3), 80, sh_degree=1, extent=1.5)
    scene = str(tmp_path / "scene.ply")
    jio.save_ply(scene, jg)
    out = tmp_path / "frames"
    cli_rollout.main(["--scene", scene, "--urdf", urdf_path, "--steps", "2",
                      "--n-cameras", "2", "--width", "48", "--height", "32",
                      "--autotune", "--device", "cpu", "--output", str(out)])
    from PIL import Image
    files = sorted(glob.glob(str(out / "frame_*.png")))
    assert len(files) == 4                          # 2 steps x 2 cameras
    assert all(np.asarray(Image.open(f)).shape == (32, 48, 3) for f in files)
    # --shard-cameras without a launcher: one rank, the same frames
    shard = tmp_path / "shard"
    cli_rollout.main(["--scene", scene, "--urdf", urdf_path, "--steps", "2",
                      "--n-cameras", "2", "--width", "48", "--height", "32",
                      "--autotune", "--device", "cpu", "--shard-cameras",
                      "--output", str(shard)])
    for f in files:
        np.testing.assert_array_equal(
            np.asarray(Image.open(f)),
            np.asarray(Image.open(str(shard / f.rsplit("/", 1)[1]))))


def _dense_lid_inputs(tmp_path):
    """The rollout workload's object (tools/workloads.py) with 16x16-quad
    box faces, at its resting place, seen by one 48x32 camera: its thin
    lid sides pile up to ~1,600 triangle bboxes in a 16x16 tile, past
    the default capacity 512. Returns (scene .ply, URDF, trajectory,
    cameras json, in-process inputs)."""
    from robosimgs_tpu_torch.core.camera import Camera
    from robosimgs_tpu_torch.core.types import Gaussians
    from robosimgs_tpu_torch.tools import workloads
    from robosimgs_tpu_torch.train.io_ply import save_ply

    urdf = workloads.write_rollout_object(str(tmp_path), n=16)
    obj = rollout.ArticulatedObject.from_urdf(urdf)
    cam_spec = [dict(workloads.ROLLOUT_CAMERAS[0], width=48, height=32)]
    cams_path = tmp_path / "cams.json"
    cams_path.write_text(json.dumps(cam_spec))
    traj_path, _ = workloads.write_rollout_inputs(str(tmp_path), obj.model,
                                                  steps=2)
    bg = Gaussians.random(torch.Generator().manual_seed(4), 80, sh_degree=1,
                          extent=1.5, device="cpu")
    scene = str(tmp_path / "scene.ply")
    save_ply(scene, bg)
    traj, poses = trajectory.load_trajectory(traj_path, [obj.model])
    cams = [Camera.look_at(c["eye"], c["target"], c["up"], c["fov"],
                          c["width"], c["height"], device="cpu")
            for c in cam_spec]
    return (scene, urdf, traj_path, str(cams_path)), (bg, obj, traj, poses,
                                                      cams)


def _cli_frames(out):
    from robosimgs_tpu_torch.utils.imresize import read_png_rgb
    return np.stack([read_png_rgb(str(out / f"frame_{t:04d}_cam0.png"))
                     for t in range(2)])[:, None]


@pytest.mark.parametrize("autotune", [True, False],
                         ids=["autotune", "default_capacity"])
def test_cli_render_rollout_mesh_capacity(tmp_path, capsys, autotune):
    """--autotune sizes the mesh tile capacity from the measured triangle
    demand (no tile overflows; the frames are the in-process render at
    that capacity); without it the frames stay the default capacity's
    and the overflow is reported on stderr."""
    from robosimgs_tpu_torch.render.autotune import (mesh_demand,
                                                     mesh_tile_capacity)
    from robosimgs_tpu_torch.render.mesh_raster import MeshRasterConfig

    (scene, urdf, traj_path, cams_path), (bg, obj, traj, poses, cams) = \
        _dense_lid_inputs(tmp_path)
    demand = mesh_demand(rollout.rollout_meshes([obj], traj, poses, "cpu"),
                         cams)
    assert demand["max_tile_count"] > 512 and demand["overflowed_tiles"] > 0
    assert demand["truncated_triangles"] == 0
    out = tmp_path / "frames"
    cli_rollout.main(["--scene", scene, "--urdf", urdf, "--trajectory",
                      traj_path, "--cameras", cams_path, "--device", "cpu",
                      "--output", str(out)] + (["--autotune"] if autotune
                                               else []))
    printed = capsys.readouterr()
    K = mesh_tile_capacity(demand["max_tile_count"]) if autotune else 512
    mesh_cfg = MeshRasterConfig(tile_capacity=K)
    if autotune:
        assert K >= demand["max_tile_count"] and K // 2 < demand["max_tile_count"]
        assert f"mesh_K={K}" in printed.out
        assert "overflowed" not in printed.err
        sized = mesh_demand(rollout.rollout_meshes([obj], traj, poses, "cpu"),
                            cams, mesh_cfg)
        assert sized["overflowed_tiles"] == 0
        cfg = recommend_capacities(bg, cams, gate_db=60.0)
    else:
        assert (f"{demand['overflowed_tiles']} overflowed tiles"
                in printed.err)
        cfg = RenderConfig()
    want = rollout.render_rollout(bg, [obj], traj, cams, cfg=cfg,
                                  mesh_cfg=mesh_cfg, base_poses=poses,
                                  as_uint8=True)
    np.testing.assert_array_equal(_cli_frames(out), want)
    if autotune:   # the sized capacity keeps triangles the default drops
        lossy = rollout.render_rollout(bg, [obj], traj, cams, cfg=cfg,
                                       base_poses=poses, as_uint8=True)
        assert (lossy != want).any()
