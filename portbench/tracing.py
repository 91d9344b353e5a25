"""The profiled window of a --trace 1 run and its reduction.

Frozen copies, so that the yardstick stays put:
  * `attribute_ops` and `_package_function` are
    robosimgs_tpu_torch/tools/profile_stages.py's: each operation's own
    device time, attributed to the innermost program frame that ran it
    or, in the backward, to the frame of the forward operation the
    autograd node differentiates (by autograd's sequence number);
  * `busy` is chip_smoke.py::trace_busy: the union of the device's
    kernel, copy and set intervals.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile
import time

import torch

PACKAGE = "robosimgs_tpu_torch/"
BACKWARD = "autograd::engine::evaluate_function: "
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profiled(device):
    """Profile the block (CPU and, on a card, CUDA activity, with the
    Python stacks that attribution needs). Yields a dict that holds, after
    the block, "prof" and the block's wall "window_s"."""
    from torch.profiler import ProfilerActivity, profile
    on_card = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    out = {}
    if on_card:
        torch.cuda.synchronize()
    with profile(activities=acts, with_stack=True,
                 experimental_config=torch.profiler._ExperimentalConfig(
                     verbose=True)) as prof:
        t0 = time.perf_counter()
        yield out
        if on_card:
            torch.cuda.synchronize()
        out["window_s"] = time.perf_counter() - t0
    out["prof"] = prof


def _package_function(event):
    for frame in event.stack or ():
        if PACKAGE in frame:
            return frame.partition(PACKAGE)[2]
    while event is not None:
        if PACKAGE in event.name and "(" in event.name:
            return event.name.partition(PACKAGE)[2]
        event = event.cpu_parent
    return None


def attribute_ops(prof, n_units: int, on_device: bool = True):
    """[(where, operation, launches a unit, ms a unit)]: 'fwd <frame>' for
    a forward operation, 'bwd <frame> <node>' for a backward one."""
    def backward_node(e):
        while e is not None and not e.name.startswith(BACKWARD):
            e = e.cpu_parent
        return e

    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    forward = {e.sequence_nr: e for e in events
               if e.sequence_nr >= 0 and backward_node(e) is None}
    rows = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU \
                or e.name.startswith(BACKWARD) or PACKAGE in e.name:
            continue
        us = e.self_device_time_total if on_device else e.self_cpu_time_total
        if us <= 0:
            continue
        node = backward_node(e.cpu_parent)
        if node is None:
            where = f"fwd {_package_function(e)}"
        else:
            kind = node.name[len(BACKWARD):].rpartition("::")[2]
            fwd = forward.get(node.sequence_nr)
            where = " ".join(x for x in ("bwd", fwd and _package_function(fwd),
                                         kind) if x)
        row = rows[(where, e.name)]
        row[0] += len(e.kernels) if on_device else 1
        row[1] += us / 1e3
    return sorted(((w, op, c / n_units, ms / n_units)
                   for (w, op), (c, ms) in rows.items()),
                  key=lambda r: -r[3])


def source_file(where: str):
    """The program file of an attribution row's `where` ('fwd
    render/project.py(97): project' -> 'render/project.py'), or None."""
    parts = where.split(" ", 1)
    if len(parts) < 2 or "(" not in parts[1]:
        return None
    return parts[1].split("(", 1)[0]


def chrome_events(prof) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]


def busy(events) -> tuple:
    """(union seconds, sorted device intervals in us) of the device
    activity in a chrome trace's events."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") in DEVICE_CATS)
    union, end = 0.0, -float("inf")
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    return union / 1e6, spans


def kernels(events) -> dict:
    """{kernel name: (launches, seconds)} of the trace's device kernels."""
    out = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            row = out[e["name"]]
            row[0] += 1
            row[1] += float(e.get("dur", 0)) / 1e6
    return {k: tuple(v) for k, v in out.items()}


def device_ops(events, top: int = 10) -> list:
    """[[operation, seconds]] of the device's busiest kernels, copies and
    sets by name, the most time first."""
    sums = collections.defaultdict(float)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            sums[e["name"][:120]] += float(e.get("dur", 0)) / 1e6
    return [[k, v] for k, v in sorted(sums.items(), key=lambda r: -r[1])[:top]]


def idle_gaps(events, spans, top: int = 10) -> list:
    """[[what the host was doing, seconds]] of the longest gaps between
    device intervals: the innermost host operation or Python function
    that spans the gap's middle."""
    gaps, end = [], None
    for a, b in spans:
        if end is not None and a > end:
            gaps.append((a - end, end, a))
        end = b if end is None else max(end, b)
    gaps.sort(reverse=True)
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "python_function", "user_annotation")]
    out = []
    for length, a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        best = None
        for e in host:
            s, d = float(e["ts"]), float(e.get("dur", 0))
            if s <= mid <= s + d and (best is None or d < best[1]):
                best = (e["name"], d)
        out.append([(best[0] if best else "no host event")[:120],
                    length / 1e6])
    return out


def reduce(window: dict, n_units: int, device) -> dict:
    """The profiled window's numbers: attribution rows, busy and window
    seconds, kernels, the breakdown."""
    on_card = torch.device(device).type == "cuda"
    events = chrome_events(window["prof"])
    busy_s, spans = busy(events)
    return {"rows": attribute_ops(window["prof"], n_units, on_card),
            "busy_s": busy_s, "window_s": window["window_s"],
            "units": n_units, "kernels": kernels(events),
            "breakdown": {"device_ops": device_ops(events),
                          "idle_gaps": idle_gaps(events, spans)}}
