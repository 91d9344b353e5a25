"""What the metric readers under portbench/metrics/ share. A reader is
`read(ctx) -> float | None`; ctx holds the measured window ("window":
units, wall_s, latencies_s, peak_bytes; training's also episode_s and
episode_steps), "setup_s", and in a --trace 1
run the reduced profile ("trace", tracing.reduce) and the needed work
("work", the entry's `work`). A reader that finds nothing to read
returns None, and the metric is left out of the line."""

from __future__ import annotations

import numpy as np

from portbench import tracing
from portbench import work as w

# the program's files a layer is made of (relative to the package)
PROJECT = ("render/project.py", "core/sh.py", "core/math3d.py",
           "core/types.py", "core/camera.py")
BINNING = ("render/binning.py", "render/tiles.py")
LOSS = ("train/losses.py",)
OPTIM = ("train/optim.py",)
MESH = ("render/mesh_raster.py", "render/compose.py")


def per_unit_ms(ctx: dict):
    win = ctx["window"]
    if not win["units"]:
        return None
    return win["wall_s"] * 1e3 / win["units"]


def median_episode_ms(ctx: dict):
    """ms a step of the window's median episode (each episode's wall over
    its steps): every episode trains the same steps from the same start
    state, so a burst of the shared host moves one episode, not this."""
    win = ctx["window"]
    eps = win.get("episode_s")
    if not eps:
        return None
    return float(np.median(eps)) * 1e3 / win["episode_steps"]


def p95_ms(ctx: dict):
    lat = ctx["window"].get("latencies_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat) * 1e3, 95))


def layer_ms(ctx: dict, files) -> float | None:
    """Device ms a unit (step or frame) of the operations that the
    layer's files launched, their backward included."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    rows = [r for r in tr["rows"] if tracing.source_file(r[0]) in files]
    if not rows:
        return None
    return sum(r[3] for r in rows)


def idle_share(ctx: dict):
    tr = ctx.get("trace")
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def roofline(ctx: dict, kind: str, prefix: str):
    """A compositing kernel's share of its roofline, in %: the mean least
    time its launches need (work.least_seconds of the work counted from
    the scene) over its mean device time a launch in the trace."""
    tr, wk = ctx.get("trace"), ctx.get("work")
    if tr is None or wk is None or not wk["launches"].get(kind):
        return None
    runs = [v for k, v in tr["kernels"].items() if prefix in k]
    n = sum(r[0] for r in runs)
    secs = sum(r[1] for r in runs)
    if not n or secs <= 0:
        return None
    need = [w.least_seconds(*x) for x in wk["launches"][kind]]
    return 100.0 * (sum(need) / len(need)) / (secs / n)


def mfu(ctx: dict):
    """The work a unit needs over the measured window's time a unit and
    the float32 peak, in %."""
    wk = ctx.get("work")
    ms = per_unit_ms(ctx)
    if wk is None or ms is None:
        return None
    return 100.0 * wk["flops_per_unit"] / (ms * 1e-3 * w.PEAK_FLOPS)
