"""Rendering a reconstructed scene: `rasterize(g, camera, cfg)` on the
scene drawn from the seed, one view a call, the configuration's views in
turn, the image (rgb, alpha, depth) copied to the host: `cli.render`'s
entry, in a closed loop.

Traffic keys: "checked" (views held against the reference after the
window), "profile_frames".

A call whose BinStats count truncated Gaussians has failed. After the
window the reference renders the sampled views of the same scene.
"""

from __future__ import annotations

import math

import torch

from portbench import checks, loop, program, scenes
from portbench.reference import splats
from portbench.reference import train as ref_train

KIND = "frame"



def setup(cell) -> dict:
    from robosimgs_tpu_torch.render.rasterize import rasterize
    dev = cell.device
    cams = scenes.cameras(cell.config["cameras"])
    g = program.gaussians(scenes.scene(cell))
    pcams = [program.camera(c, dev) for c in cams]
    cfg = program.render_config(cell.config)
    trunc = []

    def call(v):
        out = rasterize(g, pcams[v], cfg, impl="tiled", return_stats=True)
        trunc.append(out["stats"].truncated_gaussians)
        return {k: out[k].cpu().numpy() for k in ("rgb", "alpha", "depth")}

    for v in range(len(cams)):
        call(v)
    trunc.clear()
    return {"cell": cell, "cams": cams, "call": call, "trunc": trunc,
            "keys": loop.sample_keys(cell.seed, len(cams),
                                     cell.traffic["checked"])}


def window(st: dict, seconds: float) -> dict:
    cell = st["cell"]
    res = loop.closed_loop(st["call"], len(st["cams"]), seconds, st["keys"],
                           cell.seed)
    failed = int(sum(int(t > 0) for t in torch.stack(st["trunc"]).cpu()))
    st["kept"] = res.pop("kept")
    st["trunc"].clear()
    return {**res, "attempted": res["units"], "failed": failed}


def profile(st: dict):
    n = st["cell"].traffic["profile_frames"]

    def run():
        for i in range(n):
            st["call"](i % len(st["cams"]))
        st["trunc"].clear()
    return n, run


def work(st: dict) -> dict:
    from portbench import work as w
    cell = st["cell"]
    rc = program.reference_render(cell.config)
    params = scenes.scene(cell)
    deg = int(round(math.sqrt(params["sh_rest"].shape[1] + 1))) - 1
    n_g = params["means"].shape[0]
    launches, flops = [], 0
    n = cell.traffic["profile_frames"]
    cache = {}
    for i in range(n):
        v = i % len(st["cams"])
        if v not in cache:
            cam = splats.camera_tensors(st["cams"][v], cell.device)
            with torch.no_grad():
                proj = splats.project(params, cam, rc)
                c = splats.composite(proj, cam["width"], cam["height"], rc,
                                     count=True)
            cache[v] = (int(c["pairs"].sum()), int(c["entries"].sum()),
                        cam["width"] * cam["height"])
        pairs, entries, pixels = cache[v]
        launches.append(w.composite_fwd(pairs, entries, pixels, False))
        flops += w.frame_flops(n_g, deg, 1, pairs, False)
    return {"launches": {"fwd": launches}, "flops_per_unit": flops / n}


def release(st: dict) -> None:
    st.pop("call", None)


def reference(cell, cams, keys, tf32: bool = False) -> dict:
    """{view: reference {rgb, alpha, depth} as numpy}; tf32: the
    control's precision."""
    rc = program.reference_render(cell.config)
    params = scenes.scene(cell)
    out = {}
    with splats.precision(tf32):
        for v in keys:
            cam = splats.camera_tensors(cams[v], cell.device)
            r = ref_train.render(params, cam, rc)
            out[v] = {k: r[k].cpu().numpy() for k in ("rgb", "alpha", "depth")}
    return out


def compare(answers: dict, ref: dict) -> dict:
    worst = {"rgb_rms": 0.0, "alpha_rms": 0.0, "depth_rms": 0.0}
    if not answers:
        return {k: math.inf for k in worst}
    for v, a in answers.items():
        r = ref[v]
        worst["rgb_rms"] = max(worst["rgb_rms"], checks.rms(a["rgb"], r["rgb"]))
        worst["alpha_rms"] = max(worst["alpha_rms"],
                                 checks.rms(a["alpha"], r["alpha"]))
        scale = max(float(abs(r["depth"]).mean()), 1e-12)
        worst["depth_rms"] = max(worst["depth_rms"],
                                 checks.rms(a["depth"], r["depth"]) / scale)
    return worst


def readings(st: dict, control: bool) -> dict:
    """The numbers compared: of the program's answers for the sampled
    views ("program") and, with control, of the reference in the
    program's place in TF32 ("control")."""
    answers = {k: st["call"](k) for k in st["keys"]}
    release(st)
    ref = reference(st["cell"], st["cams"], st["keys"])
    out = {"program": compare(answers, ref)}
    if control:
        out["control"] = compare(reference(st["cell"], st["cams"],
                                           st["keys"], tf32=True), ref)
    return out


def check(st: dict) -> list:
    cell = st["cell"]
    kept = st.get("kept", {})
    ref = reference(cell, st["cams"], sorted(kept))
    return checks.judged(cell.limits, compare(kept, ref))
