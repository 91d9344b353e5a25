"""The benchmark's inputs, made from --seed: scenes, cameras, the URDF
object's meshes and files, and the joint trajectory.

Frozen copies, so that a later change to the program cannot change the
work measured:
  * `random_gaussians` draws as `robosimgs_tpu_torch/core/types.py::
    Gaussians.random` does (uniform means in the cube of half side
    `extent`, colours uniform in [0.1, 0.9] as the DC term, isotropic
    log-scales log(0.03 extent), quaternions (1, 0, 0, 0) + 0.1 N(0, 1),
    logit-opacities uniform in [-1, 2]), on the device from a
    torch.Generator there, in a few large calls;
  * `look_at` is `core/camera.py::Camera.look_at`'s OpenCV camera;
  * `grid_box_mesh`, `ROLLOUT_URDF` and `write_glb` are
    `tools/workloads.py::grid_box_mesh`, `ROLLOUT_URDF` and
    `utils/meshio.py::_save_glb` (positions, indices and vertex
    colours only);
  * `open_close` is `scenegen/rollout.py::open_close_trajectory`.

Everything here is numpy or plain torch: the reference reads the same
arrays the program is handed.
"""

from __future__ import annotations

import json
import math
import os
import struct

import numpy as np
import torch

SH_C0 = 0.28209479177387814

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


def generator(seed: int, device) -> torch.Generator:
    """A torch.Generator on `device` seeded from --seed (any whole
    number: it is folded into 63 bits)."""
    return torch.Generator(device=device).manual_seed(
        int(seed) % (1 << 63))


def random_gaussians(seed: int, n: int, sh_degree: int, extent: float,
                     device) -> dict:
    """{means, quats, log_scales, logit_opacities, sh_dc, sh_rest, alive}
    of n random Gaussians, f32 on `device`."""
    gen = generator(seed * 4, device)
    k = (sh_degree + 1) ** 2
    u = torch.rand((n, 9), generator=gen, device=device)
    means = (u[:, :3] * 2.0 - 1.0) * extent
    cols = u[:, 3:6] * 0.8 + 0.1
    quats = torch.randn((n, 4), generator=gen, device=device) * 0.1
    quats[:, 0] += 1.0
    return {
        "means": means.contiguous(),
        "quats": quats,
        "log_scales": torch.full((n, 3), math.log(0.03 * extent),
                                 device=device),
        "logit_opacities": (u[:, 6] * 3.0 - 1.0).contiguous(),
        "sh_dc": ((cols - 0.5) / SH_C0).contiguous(),
        "sh_rest": torch.zeros((n, k - 1, 3), device=device),
        "alive": torch.ones((n,), dtype=torch.bool, device=device),
    }


def scene(cell) -> dict:
    """The Gaussians of a cell's configuration, drawn from its seed on
    its device."""
    s = cell.config["scene"]
    return random_gaussians(cell.seed, s["n"], s["sh_degree"], s["extent"],
                            cell.device)


def redraw_colours(seed: int, params: dict) -> dict:
    """The same geometry with its SH coefficients drawn anew (the
    training targets' scene), from an independent stream of the seed: DC
    colours uniform in [0.1, 0.9], the higher bands N(0, 0.1)."""
    dev = params["means"].device
    gen = generator(seed * 4 + 1, dev)
    n = params["means"].shape[0]
    cols = torch.rand((n, 3), generator=gen, device=dev) * 0.8 + 0.1
    rest = torch.randn(params["sh_rest"].shape, generator=gen,
                       device=dev) * 0.1
    return {**params, "sh_dc": (cols - 0.5) / SH_C0, "sh_rest": rest}


def look_at(eye, target, up, fov_deg: float, width: int,
            height: int) -> dict:
    """An OpenCV-convention pinhole camera looking from eye at target:
    {c2w (4, 4), fx, fy, cx, cy, width, height} in numpy f32."""
    eye = np.asarray(eye, np.float32)
    fwd = np.asarray(target, np.float32) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float32))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    f = np.float32(0.5 * width / np.tan(0.5 * np.deg2rad(fov_deg)))
    return {"c2w": c2w, "fx": f, "fy": f, "cx": np.float32(width / 2.0),
            "cy": np.float32(height / 2.0), "width": int(width),
            "height": int(height),
            "look_at": [list(map(float, eye)), list(map(float, target)),
                        list(map(float, up)), float(fov_deg), int(width),
                        int(height)]}


def cameras(spec: dict) -> list:
    """The configuration's cameras: {"kind": "ring"} places `count`
    cameras on a circle of `radius` at `z`, the first at azimuth
    atan2(y0, x0), all looking at `target`; {"kind": "list"} gives each
    camera's eye."""
    w, h, fov = spec["width"], spec["height"], spec["fov"]
    up, target = spec.get("up", [0, 0, 1]), spec["target"]
    if spec["kind"] == "ring":
        a0 = math.atan2(spec["first"][1], spec["first"][0])
        r = math.hypot(spec["first"][0], spec["first"][1])
        eyes = [[r * math.cos(a0 + 2 * math.pi * i / spec["count"]),
                 r * math.sin(a0 + 2 * math.pi * i / spec["count"]),
                 spec["z"]] for i in range(spec["count"])]
        if eyes:
            eyes[0] = [spec["first"][0], spec["first"][1], spec["z"]]
    elif spec["kind"] == "list":
        eyes = spec["eyes"]
    else:
        raise ValueError(f"unknown camera kind {spec['kind']!r}")
    return [look_at(e, target, up, fov, w, h) for e in eyes]


def grid_box_mesh(half, n: int, color, seed: int) -> dict:
    """An axis-aligned box of half extents `half` whose six faces are
    n x n quad grids (12 n^2 triangles; face vertices not shared), with
    vertex colours: `color` shaded by a seeded factor in [0.8, 1].
    {"vertices" (V, 3) f32, "faces" (F, 3) int32, "colors" (V, 3) f32}."""
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
    return {"vertices": v, "faces": np.concatenate(faces).astype(np.int32),
            "colors": (shade * np.asarray(color)).astype(np.float32)}


def write_glb(path: str, mesh: dict) -> None:
    """A binary glTF of one triangle primitive: POSITION, COLOR_0 and
    uint32 indices."""
    pos = np.ascontiguousarray(mesh["vertices"], np.float32)
    idx = np.ascontiguousarray(mesh["faces"].reshape(-1), np.uint32)
    col = np.ascontiguousarray(mesh["colors"], np.float32)
    chunks = [pos.tobytes(), idx.tobytes(), col.tobytes()]
    views, off = [], 0
    for ch in chunks:
        views.append({"buffer": 0, "byteOffset": off, "byteLength": len(ch)})
        off += len(ch) + (-len(ch)) % 4
    accessors = [
        {"bufferView": 0, "componentType": 5126, "count": int(pos.shape[0]),
         "type": "VEC3", "min": pos.min(0).tolist(),
         "max": pos.max(0).tolist()},
        {"bufferView": 1, "componentType": 5125, "count": int(idx.shape[0]),
         "type": "SCALAR"},
        {"bufferView": 2, "componentType": 5126, "count": int(col.shape[0]),
         "type": "VEC3"}]
    data = b"".join(ch + b"\x00" * ((-len(ch)) % 4) for ch in chunks)
    gltf = {"asset": {"version": "2.0"}, "scene": 0,
            "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
            "meshes": [{"primitives": [{"attributes": {"POSITION": 0,
                                                       "COLOR_0": 2},
                                        "indices": 1, "mode": 4}]}],
            "accessors": accessors, "bufferViews": views,
            "buffers": [{"byteLength": len(data)}]}
    js = json.dumps(gltf).encode("utf-8")
    js += b" " * ((-len(js)) % 4)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<III", 0x46546C67, 2,
                             12 + 8 + len(js) + 8 + len(data)))
        fh.write(struct.pack("<II", len(js), 0x4E4F534A))
        fh.write(js)
        fh.write(struct.pack("<II", len(data), 0x004E4942))
        fh.write(data)


def box_object(seed: int, spec: dict) -> dict:
    """The rollout object: {"urdf": its text, "links": {name: mesh}}.
    The two links are grid boxes of `spec["quads"]` quads a face edge,
    shaded from the seed."""
    n = spec["quads"]
    return {"urdf": ROLLOUT_URDF, "links": {
        "body": grid_box_mesh((0.25, 0.25, 0.1), n, (0.8, 0.6, 0.4),
                              seed=(seed * 2) % (1 << 63)),
        "lid": grid_box_mesh((0.25, 0.25, 0.025), n, (0.4, 0.6, 0.8),
                             seed=(seed * 2 + 1) % (1 << 63))}}


def write_object(directory: str, obj: dict) -> str:
    """The object's URDF and one .glb a link in `directory`; returns the
    URDF's path."""
    for name, mesh in obj["links"].items():
        write_glb(os.path.join(directory, f"{name}.glb"), mesh)
    path = os.path.join(directory, "object.urdf")
    with open(path, "w") as fh:
        fh.write(obj["urdf"])
    return path


def open_close(lower: float, upper: float, steps: int) -> np.ndarray:
    """(steps, 1) joint positions: open, then close, through the range."""
    ts = np.linspace(0.0, 1.0, steps)
    phase = 0.5 - 0.5 * np.cos(2 * np.pi * ts)
    return (lower + phase * (upper - lower))[:, None].astype(np.float32)
