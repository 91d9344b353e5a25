"""Training: `Trainer.run` on the configuration's views, one step a view
in turn, the default eager path (fused_steps 0).

Traffic keys: "first_step" (the Trainer's step counter at the start of
every episode), "episode" (steps a `Trainer.run` call), "checked" (the
first steps held against the reference), "profile_steps".

Every episode starts from the same state: the scene drawn from the seed,
a fresh optimizer and the step counter at `first_step`. So every window
trains the same states whatever its speed, and never reaches a densify
round, an opacity reset or a checkpoint; the Trainer's own checks every
`log_every` steps (the logged loss, the pool size) stay.

Set-up builds one Trainer and runs one episode with it, which warms up
every shape: its first `checked` steps through `Trainer.run` logging
every step, the program's numbers read from its state (the first
gradient from Adam's first moment after one step, the parameters' change
after the checked steps), then the rest of the episode, whose end state
the program's own BinStats check for truncated Gaussians on every view
(every episode trains the same states). The same Trainer goes to the
window. Once the window has closed, the same warmed Trainer runs the
checked steps from the start state once more and its numbers are read
again, so that a fault of warmed calls (a cache, reused buffers, state
carried across episodes) is held to the reference too. Then the
reference trains the same scene from the same start for the checked
steps, and each number compared is the worse of the two readings.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

from portbench import checks, program, scenes
from portbench.reference import splats
from portbench.reference import train as ref_train

KIND = "train"
FIELDS = ref_train.FIELDS



def _cameras(cell) -> list:
    return scenes.cameras(cell.config["cameras"])


def _train_config(cell):
    from robosimgs_tpu_torch.train.optim import OptimConfig
    from robosimgs_tpu_torch.train.trainer import TrainConfig
    t = dict(cell.config["train"])
    optim = OptimConfig(**t.pop("optim"))
    t["background"] = tuple(t["background"])
    return TrainConfig(render=program.render_config(cell.config),
                       optim=optim, impl="tiled", **t)


def setup(cell) -> dict:
    from robosimgs_tpu_torch.train.data import Frame
    from robosimgs_tpu_torch.train.trainer import Trainer
    tr = cell.traffic
    dev = cell.device
    params = scenes.scene(cell)
    cams = _cameras(cell)
    rc = program.reference_render(cell.config)
    rcams = [splats.camera_tensors(c, dev) for c in cams]
    bg = torch.tensor(cell.config["train"]["background"],
                      dtype=torch.float32, device=dev)
    colours = scenes.redraw_colours(cell.seed, params)
    targets = [ref_train.render(colours, c, rc, bg)["rgb"] for c in rcams]
    del colours
    frames = [Frame(camera=program.camera(c, dev), image=t.cpu().numpy())
              for c, t in zip(cams, targets)]
    cfg = _train_config(cell)
    trainer = Trainer(cfg, program.gaussians(params), frames)
    del params
    trainer.state = dataclasses.replace(trainer.state,
                                        step=tr["first_step"])
    start = trainer.state
    cold = _checked_steps(trainer, start, tr["checked"])
    trainer.run(iterations=tr["episode"] - tr["checked"], progress=False)
    truncated = _truncated(trainer.state, cams, cell)
    trainer.state = start
    trainer.history.clear()
    return {"cell": cell, "trainer": trainer, "start": start, "cams": cams,
            "targets": targets, "truncated": truncated, "program": [cold]}


def _checked_steps(trainer, start, checked: int) -> dict:
    """The program's numbers of the first `checked` steps from `start`,
    through the window's own call (`Trainer.run`, its reads of the loss
    made every step): each step's loss, the first gradient's norms (from
    Adam's first moment after one step) and the change's norms after the
    checked steps. Leaves the trainer after them, its config as it was."""
    cfg = trainer.cfg
    logged = []
    trainer.state = start
    trainer.cfg = dataclasses.replace(cfg, log_every=1)
    trainer.run(iterations=1, progress=False, on_log=logged.append)
    b1 = cfg.optim.b1
    first = checks.norms({k: trainer.state.opt_state[k].mu / (1 - b1)
                          for k in FIELDS})
    trainer.run(iterations=checked - 1, progress=False,
                on_log=logged.append)
    change = checks.norms({k: getattr(trainer.state.gaussians, k)
                           - getattr(start.gaussians, k) for k in FIELDS})
    trainer.cfg = cfg
    return {"losses": [float(m["loss"]) for m in logged],
            "first_grads": first, "change": change}


def window(st: dict, seconds: float) -> dict:
    """Episodes of `episode` steps from the start state until `seconds`
    have passed, each ended by a synchronise, its wall kept in
    "episode_s"."""
    trainer, n = st["trainer"], st["cell"].traffic["episode"]
    dev = st["cell"].device
    logs = []
    episode_s = []
    program.sync(dev)
    t0 = t1 = time.perf_counter()
    while True:
        trainer.state = st["start"]
        trainer.run(iterations=n, progress=False, on_log=logs.append)
        program.sync(dev)
        t2 = time.perf_counter()
        episode_s.append(t2 - t1)
        t1 = t2
        if t2 - t0 >= seconds:
            break
    wall = time.perf_counter() - t0
    steps = len(episode_s) * n
    trainer.state = st["start"]
    bad = sum(1 for m in logs if not math.isfinite(m["loss"]))
    failed = steps if st["truncated"] else min(steps, bad * n)
    return {"units": steps, "wall_s": wall, "latencies_s": None,
            "attempted": steps, "failed": failed, "episode_s": episode_s,
            "episode_steps": n}


def after_window(st: dict) -> None:
    """The checked steps once more, from the start state, on the Trainer
    the window warmed."""
    trainer = st["trainer"]
    st["program"].append(_checked_steps(trainer, st["start"],
                                        st["cell"].traffic["checked"]))
    trainer.state = st["start"]
    trainer.history.clear()


def profile(st: dict):
    trainer, n = st["trainer"], st["cell"].traffic["profile_steps"]

    def run():
        trainer.state = st["start"]
        trainer.run(iterations=n, progress=False)
        trainer.state = st["start"]
    return n, run


def work(st: dict) -> dict:
    """The needed work of the profiled steps, on the start state: each
    step's view walked by the reference (pairs, entries)."""
    from portbench import work as w
    cell = st["cell"]
    tr = cell.traffic
    rc = program.reference_render(cell.config)
    params = scenes.scene(cell)
    deg = int(round(math.sqrt(params["sh_rest"].shape[1] + 1))) - 1
    n_g = params["means"].shape[0]
    per_view = {}
    launches = {"fwd": [], "bwd": []}
    flops = 0
    for i in range(tr["profile_steps"]):
        v = (tr["first_step"] + i) % len(st["cams"])
        if v not in per_view:
            cam = splats.camera_tensors(st["cams"][v], cell.device)
            with torch.no_grad():
                proj = splats.project(params, cam, rc)
                c = splats.composite(proj, cam["width"], cam["height"], rc,
                                     count=True)
            per_view[v] = (int(c["pairs"].sum()), int(c["entries"].sum()),
                           cam["width"] * cam["height"])
        pairs, entries, pixels = per_view[v]
        launches["fwd"].append(w.composite_fwd(pairs, entries, pixels, False))
        launches["bwd"].append(w.composite_bwd(pairs, entries, pixels))
        flops += w.train_step_flops(n_g, deg, pixels, pairs, pairs)
    return {"launches": launches, "flops_per_unit": flops / tr["profile_steps"]}


def _truncated(state, cams, cell) -> int:
    """Truncated Gaussians of a training state over every view, as the
    program's binning counts them."""
    from robosimgs_tpu_torch.render.rasterize import rasterize
    cfg = program.render_config(cell.config)
    trunc = 0
    with torch.no_grad():
        for c in cams:
            out = rasterize(state.gaussians, program.camera(c, cell.device),
                            cfg, impl="tiled", return_stats=True)
            trunc += int(out["stats"].truncated_gaussians)
    return trunc


def release(st: dict) -> None:
    """Drop the program's state."""
    st.pop("trainer", None)
    st.pop("start", None)


def reference(cell, cams, targets, half_rows: bool = False,
              tf32: bool = False) -> dict:
    """The reference's readings of the checked steps from the seed's
    scene: losses, first-gradient norms, change norms (tf32: the
    control's precision; half_rows: a planted fault)."""
    rc = program.reference_render(cell.config)
    tc = cell.config["train"]
    rcams = [splats.camera_tensors(c, cell.device) for c in cams]
    p0 = scenes.scene(cell)
    with splats.precision(tf32):
        out = ref_train.train(p0, rcams, targets, rc, tc,
                              cell.traffic["first_step"],
                              cell.traffic["checked"], half_rows)
    return {"losses": out["losses"],
            "first_grads": checks.norms(out["first_grads"]),
            "change": checks.norms({k: out["params"][k] - p0[k]
                                    for k in FIELDS})}


def compare(prog: dict, ref: dict) -> dict:
    quiet = checks.quiet_leaves(ref["first_grads"])
    return {"loss_gap": checks.loss_gap(prog["losses"], ref["losses"]),
            "grad_gap": checks.leaf_gap(prog["first_grads"],
                                        ref["first_grads"]),
            "change_gap": checks.leaf_gap(prog["change"], ref["change"],
                                          skip=quiet)}


def readings(st: dict, control: bool) -> dict:
    """The numbers compared, of the program ("program": the worse of its
    readings, from set-up and, after a window, from the warmed Trainer)
    and, with control, of the reference in the program's place in TF32
    ("control") and with half the image left out of the loss
    ("half_batch")."""
    cell, cams, targets = st["cell"], st["cams"], st["targets"]
    release(st)
    ref = reference(cell, cams, targets)
    gaps = [compare(p, ref) for p in st["program"]]
    out = {"program": {**{k: max(g[k] for g in gaps) for k in gaps[0]},
                       "truncated": st["truncated"]}}
    if control:
        for name, kw in (("control", {"tf32": True}),
                         ("half_batch", {"half_rows": True})):
            out[name] = {**compare(reference(cell, cams, targets, **kw),
                                   ref), "truncated": 0}
    return out


def check(st: dict) -> list:
    return checks.judged(st["cell"].limits,
                         readings(st, control=False)["program"])
