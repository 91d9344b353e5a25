"""Tracing and metrics: the port of robosimgs_tpu/utils/profiling.py.

  trace(log_dir)  — torch.profiler over the CPU and, where there is one,
                    the card; writes a Chrome/Perfetto trace JSON
  StageTimer      — wall-clock stage timing that waits for the stage's
                    queued device work; on the card each stage is also
                    timed by CUDA events
  MetricsLogger   — append-only JSONL scalar metrics (loss, PSNR,
                    Gaussian count, throughput)
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write <log_dir>/trace_<pid>_<ns>.json, a
    Chrome trace (chrome://tracing, ui.perfetto.dev). Yields the
    profiler; its path is `prof.trace_path` after the block."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.trace_path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


def _sync(tensors) -> Optional[torch.device]:
    """Wait for the devices of `tensors` (a tensor or a nested list,
    tuple or dict of them); the first CUDA device found, else None."""
    found = None
    stack = [tensors]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda" and found is None:
                found = x.device
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    if found is not None:
        torch.cuda.synchronize(found)
    return found


class StageTimer:
    """Stage timing. `stage(name, sync_on=x)` waits at the end for the
    device work that produces x (a tensor or a nested container of
    them), so the stage's host time includes it; where x lies on the
    card the stage is also timed by CUDA events around it (`device_ms`).
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.device_totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        events = None
        if sync_on is not None and torch.cuda.is_available():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                if events is not None:
                    events[1].record()
                if _sync(sync_on) is not None and events is not None:
                    events[1].synchronize()
                    self.device_totals[name] = (
                        self.device_totals.get(name, 0.0)
                        + events[0].elapsed_time(events[1]) / 1e3)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        """Mean host seconds per call of each stage."""
        return {k: self.totals[k] / self.counts[k] for k in self.totals}

    def device_ms(self) -> Dict[str, float]:
        """Mean CUDA-event milliseconds per call of each stage timed on
        the card."""
        return {k: self.device_totals[k] / self.counts[k] * 1e3
                for k in self.device_totals}

    def report(self) -> str:
        return "\n".join(
            f"{k:24s} {self.totals[k]/self.counts[k]*1000:9.2f} ms/call"
            f"  x{self.counts[k]}" for k in sorted(self.totals))


class MetricsLogger:
    """Scalar rows {"step", "time", **scalars}, kept in `rows` and, with
    a path, appended to it as JSON lines."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.rows = []

    def log(self, step: int, **scalars):
        row = {"step": step, "time": time.time()}
        for k, v in scalars.items():
            row[k] = float(v)
        self.rows.append(row)
        if self.path:
            with open(self.path, "a") as fh:
                fh.write(json.dumps(row) + "\n")
        return row
