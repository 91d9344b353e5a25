"""Simulated data and closed-loop evaluation: `render_rollout(background,
objects, q[None], cameras)`, one timestep a call, the next call after the
previous returns (as `policy/rollout_eval.py` observes), the episode's
timesteps in turn for the whole window. The frames come back to the host
as the entry returns them.

Traffic keys: "object" (true: the configuration's URDF object, posed by
its open-close sweep; false: the splats alone), "checked" (timesteps held
against the reference after the window), "profile_frames".

The object's URDF and meshes are written under TMPDIR and loaded by the
program's own `ArticulatedObject.from_urdf`; the reference poses the same
arrays from the URDF text. `render_rollout` reports no truncation, so
`failed` counts none; the check sees what it would change.
"""

from __future__ import annotations

import math
import tempfile
import xml.etree.ElementTree as ET

import numpy as np
import torch

from portbench import checks, loop, program, scenes
from portbench.reference import mesh as ref_mesh
from portbench.reference import splats

KIND = "frame"



def _object(cell):
    spec = cell.config["object"]
    return spec, scenes.box_object(cell.seed, spec)


def trajectory(obj: dict, steps: int) -> np.ndarray:
    """(steps, dof) open-close sweep of the object's movable joint."""
    root = ET.fromstring(obj["urdf"])
    (joint,) = [j for j in root.findall("joint") if j.get("type") in
                ("revolute", "continuous", "prismatic")]
    lim = joint.find("limit")
    return scenes.open_close(float(lim.get("lower")), float(lim.get("upper")),
                             steps)


def base_pose(spec: dict) -> np.ndarray:
    base = np.eye(4, dtype=np.float32)
    base[:3, 3] = spec["base"]
    return base


def setup(cell) -> dict:
    from robosimgs_tpu_torch.render.mesh_raster import MeshRasterConfig
    from robosimgs_tpu_torch.scenegen.rollout import (ArticulatedObject,
                                                      render_rollout)
    dev = cell.device
    cams = scenes.cameras(cell.config["cameras"])
    g = program.gaussians(scenes.scene(cell))
    pcams = [program.camera(c, dev) for c in cams]
    cfg = program.render_config(cell.config)
    spec, obj = _object(cell)
    steps = spec["episode"]
    if cell.traffic["object"]:
        with tempfile.TemporaryDirectory() as tmp:
            path = scenes.write_object(tmp, obj)
            objects = [ArticulatedObject.from_urdf(path,
                                                   base_pose=base_pose(spec))]
        traj = trajectory(obj, steps)
    else:
        objects, traj = [], np.zeros((steps, 0), np.float32)
    mesh_cfg = MeshRasterConfig(**cell.config["mesh"])

    def call(s):
        return render_rollout(g, objects, traj[s][None], pcams, cfg,
                              mesh_cfg, impl="tiled")

    for s in range(steps):
        call(s)
    return {"cell": cell, "cams": cams, "call": call, "steps": steps,
            "spec": spec, "obj": obj, "traj": traj,
            "keys": loop.sample_keys(cell.seed, steps,
                                     cell.traffic["checked"])}


def window(st: dict, seconds: float) -> dict:
    cell = st["cell"]
    res = loop.closed_loop(st["call"], st["steps"], seconds, st["keys"],
                           cell.seed)
    st["kept"] = res.pop("kept")
    return {**res, "attempted": res["units"], "failed": 0}


def profile(st: dict):
    n = st["cell"].traffic["profile_frames"]

    def run():
        for i in range(n):
            st["call"](i % st["steps"])
    return n, run


def release(st: dict) -> None:
    st.pop("call", None)


def _links(st: dict, s: int) -> list:
    if not st["cell"].traffic["object"]:
        return []
    return ref_mesh.posed_links(st["obj"], st["traj"][s],
                                base_pose(st["spec"]))


def reference(st: dict, keys, tf32: bool = False, count: bool = False):
    """{timestep: ((C, H, W, 3) reference frame, (C, H, W) ambiguous
    pixels)}, tf32: the control's precision (and with count, the needed
    work of each camera: {timestep: [(pairs, entries, pixels, mesh
    vertices, mesh candidates)]})."""
    cell = st["cell"]
    rc = program.reference_render(cell.config)
    params = scenes.scene(cell)
    near = cell.config["mesh"].get("near", 0.01)
    bg = torch.zeros(3, device=cell.device)
    frames, work = {}, {}
    with splats.precision(tf32):
        for s in keys:
            links = _links(st, s)
            views, amb, w = [], [], []
            for c in st["cams"]:
                cam = splats.camera_tensors(c, cell.device)
                f = ref_mesh.frame(params, links, cam, rc, near, bg,
                                   count=count)
                views.append(f["rgb"].cpu().numpy())
                amb.append(f["ambiguous"].cpu().numpy())
                if count:
                    w.append((int(f["pairs"].sum()), int(f["entries"].sum()),
                              cam["width"] * cam["height"],
                              sum(v.shape[0] for v, _, _ in links),
                              int(f.get("candidates", 0))))
            frames[s] = (np.stack(views), np.stack(amb))
            work[s] = w
    return (frames, work) if count else frames


def work(st: dict) -> dict:
    from portbench import work as w
    cell = st["cell"]
    n = cell.traffic["profile_frames"]
    s_cfg = cell.config["scene"]
    keys = sorted({i % st["steps"] for i in range(n)})
    _, per = reference(st, keys, count=True)
    dl = bool(cell.traffic["object"])
    launches, flops = [], 0
    for i in range(n):
        cams = per[i % st["steps"]]
        for pairs, entries, pixels, _, _ in cams:
            launches.append(w.composite_fwd(pairs, entries, pixels, dl))
        flops += w.frame_flops(
            s_cfg["n"], s_cfg["sh_degree"], len(cams),
            sum(c[0] for c in cams), dl, cams[0][3] if cams else 0,
            sum(c[4] for c in cams))
    return {"launches": {"fwd": launches}, "flops_per_unit": flops / n}


def compare(answers: dict, ref: dict) -> dict:
    """The worst sampled frame's rgb rms and share of pixels off by more
    than 1/255, over the pixels that the reference finds unambiguous."""
    if not answers:
        return {"rgb_rms": math.inf, "bad_px": math.inf}
    rms, bad = [], []
    for s, a in answers.items():
        frame, amb = ref[s]
        clear = ~amb
        rms.append(checks.rms(a[0][clear], frame[clear]))
        bad.append(checks.bad_pixels(a[0][clear], frame[clear]))
    return {"rgb_rms": max(rms), "bad_px": max(bad)}


def readings(st: dict, control: bool) -> dict:
    """The numbers compared: of the program's frames for the sampled
    timesteps ("program") and, with control, of the reference in the
    program's place in TF32 ("control")."""
    answers = {k: st["call"](k) for k in st["keys"]}
    release(st)
    ref = reference(st, st["keys"])
    out = {"program": compare(answers, ref)}
    if control:
        low = reference(st, st["keys"], tf32=True)
        out["control"] = compare({k: v[0][None] for k, v in low.items()},
                                 ref)
    return out


def check(st: dict) -> list:
    kept = st.get("kept", {})
    ref = reference(st, sorted(kept))
    return checks.judged(st["cell"].limits, compare(kept, ref))
