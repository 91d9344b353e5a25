"""The scenes and the timer that the port's kernel measurements share:
chip_smoke.py, tools/kernel_ab.py and tests/test_torch_cuda.py build
their cases from here, so they check and time the same work.

The bench workload is the JAX package's bench.py render (100k random
Gaussians, SH degree 3, extent 1.5, 256x256, look_at([4, 0.5, 1.2] -> 0,
60 deg), K=384, M=10, bbox 12, two-tier 4/0.15), drawn from
torch.Generator seed 0.

The feasibility workload is the JAX package's largest single-chip
scene, scripts/feasibility_3m.py:34-45,75-78: 3M random Gaussians, SH
degree 3, extent 1.5, 512x512 from the bench camera, 32-px tiles (16-px
tiles overflow the JAX binner's packed 31-bit sort key at 3M), K=2048
(gated against K=4096), tile_chunk 512, M=16, bbox 20, single tier,
drawn from torch.Generator seed 5.

The staged workload is the JAX package's lossless 1M-Gaussian staged
config, scripts/staged_lossless.py and bench.py's `_staged` (bench.py:
210-300): 1M random Gaussians, SH degree 3, extent 1.5, 512x512 from
the bench camera, 16-px tiles, M=24 over a 28-tile bbox, K=384 with a
two-tier split of 12 gated against the lossless K=22,016, drawn from
torch.Generator seed 1. Those constants were measured on the JAX
package's jax.random draw; tools/staged_lossless.py measures this draw's
covers and demand first and keeps them where they fit.

The rollout workload has the statistics of bench.py's rollout config
(200k random Gaussians, SH degree 2, extent 1.5, four 640x480 cameras at
look_at([3.0 + 0.1 i, 0.4, 1.0] -> 0, 60 deg), K=512, M=64, bbox 84,
two-tier split 12), drawn from torch.Generator seed 2, with the
box-with-hinged-lid object of the JAX package's tests/test_scenegen.py at
half its size, each box face a 32x32 quad grid (24,576 triangles), placed
between the cameras and the splats. Its mesh tile capacity is 2048: the
lid's thin side faces (0.5 x 0.05 m, 2,048 triangles each) seen near edge
on pile up to ~1,500 triangle bboxes in a 16x16 tile (measured over the
8 steps x 4 views), past the default 512.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch

from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.core.types import Gaussians
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.mesh_raster import MeshRasterConfig
from robosimgs_tpu_torch.utils.meshio import Mesh, save_mesh

BENCH_GAUSSIANS = 100_000
BENCH_RES = 256
FEASIBILITY_GAUSSIANS = 3_000_000
FEASIBILITY_RES = 512
STAGED_GAUSSIANS = 1_000_000
STAGED_RES = 512
# the JAX package's constants (scripts/staged_lossless.py:38-40): M and
# bbox at or above its draw's max survivor / bbox cover (22 / 25), the
# lossless K at or above its max per-tile demand (21,626), rounded up
# to 512
STAGED_M = 24
STAGED_BBOX = 28
STAGED_K_LOSSLESS = 22_016
STAGED_K = 384
STAGED_SPLIT = 12
ROLLOUT_GAUSSIANS = 200_000
ROLLOUT_STEPS = 8
ROLLOUT_CAMERAS = [dict(eye=[3.0 + 0.1 * i, 0.4, 1.0], target=[0, 0, 0],
                        up=[0, 0, 1], fov=60.0, width=640, height=480)
                   for i in range(4)]
# the object's resting place: on the cameras' line of sight, in front of
# the splat cube (|x| <= 1.5)
ROLLOUT_BASE = (1.8, 0.24, 0.6)
ROLLOUT_MESH = MeshRasterConfig(tile_capacity=2048)
ROLLOUT_URDF = """<?xml version="1.0"?>
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
    <origin xyz="0 0.25 0.1" rpy="0 0 0"/>
    <axis xyz="1 0 0"/>
    <limit lower="0.0" upper="1.57" effort="5" velocity="2"/>
    <dynamics friction="0.5" damping="0.2"/>
  </joint>
</robot>"""


def bench_config() -> RenderConfig:
    return RenderConfig(tile_capacity=384, max_tiles_per_gaussian=10,
                        bbox_tiles_per_gaussian=12, two_tier_split=4,
                        two_tier_spill_frac=0.15)


def bench_scene(device, n: int = BENCH_GAUSSIANS):
    """(Gaussians, camera, RenderConfig) of the bench workload."""
    g = Gaussians.random(torch.Generator().manual_seed(0), n, sh_degree=3,
                         extent=1.5, device=device)
    cam = Camera.look_at([4.0, 0.5, 1.2], [0, 0, 0], [0, 0, 1], 60.0,
                         BENCH_RES, BENCH_RES, device=device)
    return g, cam, bench_config()


def feasibility_config(tile_capacity: int = 2048) -> RenderConfig:
    return RenderConfig(tile_size=32, tile_capacity=tile_capacity,
                        tile_chunk=512, max_tiles_per_gaussian=16,
                        bbox_tiles_per_gaussian=20)


def feasibility_scene(device, n: int = FEASIBILITY_GAUSSIANS):
    """(Gaussians, camera, RenderConfig) of the feasibility workload."""
    g = Gaussians.random(torch.Generator().manual_seed(5), n, sh_degree=3,
                         extent=1.5, device=device)
    cam = Camera.look_at([4.0, 0.5, 1.2], [0, 0, 0], [0, 0, 1], 60.0,
                         FEASIBILITY_RES, FEASIBILITY_RES, device=device)
    return g, cam, feasibility_config()


def staged_config(k: int = STAGED_K, split: int = 0, spill_frac: float = 0.0,
                  m: int = STAGED_M, bbox: int = STAGED_BBOX) -> RenderConfig:
    """The staged workload's RenderConfig at capacity k: tile_chunk 512
    where it divides k (else one chunk), M over a bbox enumeration, and
    a two-tier split with its spill fraction (0 = one tier)."""
    return RenderConfig(tile_capacity=k, tile_chunk=512 if k % 512 == 0 else 0,
                        max_tiles_per_gaussian=m, bbox_tiles_per_gaussian=bbox,
                        two_tier_split=split, two_tier_spill_frac=spill_frac)


def staged_scene(device, n: int = STAGED_GAUSSIANS, res: int = STAGED_RES):
    """(Gaussians, camera) of the staged workload; its RenderConfig is
    `staged_config`, sized to the draw by tools/staged_lossless.py."""
    g = Gaussians.random(torch.Generator().manual_seed(1), n, sh_degree=3,
                         extent=1.5, device=device)
    cam = Camera.look_at([4.0, 0.5, 1.2], [0, 0, 0], [0, 0, 1], 60.0, res,
                         res, device=device)
    return g, cam


def orbit_views(g: Gaussians, device):
    """[(camera, RenderConfig)] of the render CLI's two 640x480 orbit views
    of g, with the CLI's default RenderConfig (K=1024)."""
    from robosimgs_tpu_torch.cli.render import orbit_cameras
    return [(c, RenderConfig())
            for c in orbit_cameras(g, 2, 60.0, 640, 480, device=device)]


def saturated_scene(device, n: int = 256):
    """n near-opaque splats stacked on the corner the four tiles of a 32x32
    view share (the JAX package's saturated-gradient regression scene,
    tests/test_tiled.py::test_saturated_pixel_gradients_nonzero, with
    wider splats): the middle pixels saturate within the first 16-splat
    groups, the image corners do not. (Gaussians, camera, RenderConfig)."""
    g = Gaussians.random(torch.Generator().manual_seed(0), n, sh_degree=1,
                         device=device)
    means = torch.zeros((n, 3))
    means[:, 0] = torch.linspace(-0.01, 0.01, n)
    g = g.replace(means=means.to(device),
                  log_scales=torch.full((n, 3), math.log(0.5), device=device),
                  logit_opacities=torch.full((n,), 6.0, device=device))
    cam = Camera.look_at([2.5, 0.0, 0.0], [0, 0, 0], [0, 0, 1], 45.0, 32, 32,
                         device=device)
    return g, cam, RenderConfig(tile_capacity=384)


def rollout_config() -> RenderConfig:
    return RenderConfig(tile_capacity=512, tile_chunk=512,
                        max_tiles_per_gaussian=64, bbox_tiles_per_gaussian=84,
                        two_tier_split=12, two_tier_spill_frac=0.44864)


def rollout_scene(device, n: int = ROLLOUT_GAUSSIANS):
    """(Gaussians, [Camera] x 4, RenderConfig) of the rollout workload.

    The config's spill tier is sized to this scene: bench.py's 0.44864 is
    the share of its (jax.random) scene's splats that cover more than 12
    tiles after the cull; this draw's share is measured over the four
    views (per_gaussian_cover), so the spill keeps every such splat and
    nothing is truncated."""
    from robosimgs_tpu_torch.render.binning import per_gaussian_cover
    from robosimgs_tpu_torch.render.project import project

    g = Gaussians.random(torch.Generator().manual_seed(2), n, sh_degree=2,
                         extent=1.5, device=device)
    cams = [Camera.look_at(c["eye"], c["target"], c["up"], c["fov"],
                           c["width"], c["height"], device=device)
            for c in ROLLOUT_CAMERAS]
    cfg = rollout_config()
    with torch.no_grad():
        spill = max(int((per_gaussian_cover(
            project(g, c, cfg), c.width, c.height, cfg,
            cfg.bbox_tiles_per_gaussian) > cfg.two_tier_split).sum())
            for c in cams)
    return g, cams, dataclasses.replace(cfg,
                                        two_tier_spill_frac=(spill + 0.5) / n)


def grid_box_mesh(half, n: int, color, seed: int) -> Mesh:
    """An axis-aligned box of half extents `half` whose six faces are n x n
    quad grids (12 n^2 triangles), with vertex colors: `color` shaded by
    a seeded factor in [0.8, 1]. Face vertices are not shared."""
    t = np.linspace(-1.0, 1.0, n + 1, dtype=np.float32)
    uu, vv = np.meshgrid(t, t, indexing="ij")
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    a = (i * (n + 1) + j).reshape(-1)
    quads = np.stack([a, a + n + 1, a + n + 2, a + 1], -1)
    tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
    verts, faces = [], []
    for axis in range(3):
        u_ax, v_ax = [k for k in range(3) if k != axis]
        for sign in (-1.0, 1.0):
            p = np.zeros(((n + 1) ** 2, 3), np.float32)
            p[:, axis] = sign
            p[:, u_ax], p[:, v_ax] = uu.reshape(-1), vv.reshape(-1)
            faces.append(tris + sum(len(x) for x in verts))
            verts.append(p * np.asarray(half, np.float32))
    v = np.concatenate(verts)
    shade = np.random.default_rng(seed).uniform(0.8, 1.0, (len(v), 1))
    return Mesh(vertices=v, faces=np.concatenate(faces).astype(np.int32),
                vertex_colors=(shade * np.asarray(color)).astype(np.float32))


def open_box_parts(n_body: int = 100, n_lid: int = 65,
                   open_deg: float = 60.0):
    """The articulation workload's two parts, (body, lid): a body of half
    extents (0.25, 0.25, 0.1) and a lid of (0.25, 0.25, 0.025), grid boxes
    of n_body and n_lid quads a face edge, the lid opened open_deg degrees
    about the body's back top edge (y = 0.25, z = 0.1, along x), so the
    parts meet along that line. At the defaults 87,342 vertices and
    170,700 triangles, the size of the upstream openbox scan."""
    body = grid_box_mesh((0.25, 0.25, 0.1), n_body, (0.8, 0.6, 0.4), seed=0)
    lid = grid_box_mesh((0.25, 0.25, 0.025), n_lid, (0.4, 0.6, 0.8), seed=1)
    a = -np.deg2rad(open_deg)           # the lid's front rises
    rot = np.array([[1.0, 0.0, 0.0], [0.0, np.cos(a), -np.sin(a)],
                    [0.0, np.sin(a), np.cos(a)]])
    edge = np.array([0.0, 0.25, 0.1])
    # the lid resting on the body: its back bottom edge on the hinge line
    v = lid.vertices.astype(np.float64) + np.array([0.0, 0.0, 0.125]) - edge
    lid.vertices = (v @ rot.T + edge).astype(np.float32)
    return body, lid


def write_rollout_object(directory: str, n: int = 32) -> str:
    """Write the rollout object (URDF + two untextured .glb links with
    vertex colors, each box face an n x n grid) into directory; returns
    the URDF's path."""
    save_mesh(os.path.join(directory, "body.glb"),
              grid_box_mesh((0.25, 0.25, 0.1), n, (0.8, 0.6, 0.4), seed=0))
    save_mesh(os.path.join(directory, "lid.glb"),
              grid_box_mesh((0.25, 0.25, 0.025), n, (0.4, 0.6, 0.8), seed=1))
    path = os.path.join(directory, "object.urdf")
    with open(path, "w") as fh:
        fh.write(ROLLOUT_URDF)
    return path


def write_rollout_inputs(directory: str, model, steps: int = ROLLOUT_STEPS):
    """Write the rollout's trajectory (an open-close sweep of the hinge,
    the object at ROLLOUT_BASE) and camera list as the render_rollout
    CLI reads them; returns (trajectory path, cameras path)."""
    from robosimgs_tpu_torch.scenegen.rollout import open_close_trajectory
    from robosimgs_tpu_torch.scenegen.trajectory import save_trajectory

    base = np.eye(4, dtype=np.float32)
    base[:3, 3] = ROLLOUT_BASE
    traj = os.path.join(directory, "trajectory.json")
    save_trajectory(traj, [model.name], open_close_trajectory(model, steps),
                    base_poses=np.tile(base, (steps, 1, 1, 1)),
                    dofs=[model.dof])
    cams = os.path.join(directory, "cameras.json")
    with open(cams, "w") as fh:
        json.dump(ROLLOUT_CAMERAS, fh)
    return traj, cams


def open_device(name: str, tool: str):
    """torch.device(name) for a tool's --device, or None (after a line on
    stderr) when it is a CUDA device and none is present."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"{tool}: no CUDA device (--device cpu runs the plain "
              "versions)", file=sys.stderr)
        return None
    return dev


def timer(device):
    """(time_ms on a CUDA device, host_ms elsewhere; the timer's name for
    a result to carry beside its numbers)."""
    if torch.device(device).type == "cuda":
        return time_ms, "cuda events"
    return host_ms, "host clock"


def host_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean ms of fn over reps calls by the host's clock, after warmup
    calls: for runs on the CPU, where no device clock exists."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean ms of fn over reps calls on the current CUDA stream (CUDA
    events), after warmup calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps
