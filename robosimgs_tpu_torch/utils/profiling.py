"""Tracing: the port of robosimgs_tpu/utils/profiling.py, and the
program's own spans and counters.

  trace(log_dir)  — torch.profiler over the CPU and, where there is one,
                    the card (over a schedule's active steps, when given
                    one); writes a Chrome/Perfetto trace JSON and, beside
                    it, the recorder's summary() of what it recorded
  span(name)      — a named range of the program, as a context manager
                    or a decorator
  count(name, v)  — adds v to a named counter
  summary()       — per span name: calls, roots, host ms, self host ms,
                    device ms; and the counters' values
  reset()         — forgets every record and counter
  device_rows(p)  — a profile's device activity rows, without the spans'
                    own device ranges

Spans and counters record only while a torch profiler records (`trace`,
or any `torch.profiler.profile`). Otherwise `span` hands back a shared
no-op context and `count` returns at once: one flag check, no
record_function, no CUDA event, no device operation. While recording, a
span is also a `record_function` range, so it lands in the profiler's
trace on the clock of the device events (on a card, with a
`gpu_user_annotation` range over the device work launched inside it),
and its record keeps its parent (the span open around it), its root (the
outermost one: the unit of work it belongs to), its thread and its host
start and end. A span made with `device_time=True` also records, on a
card and outside a CUDA-graph capture, a pair of timing events on the
current stream: what a reading of its device ms needs. Other spans skip
the events, which are most of a span's cost under a profiler that
records Python stacks. Off a card a span's device time is its host time.
A counter takes host ints and 0-d tensors; it keeps the tensors and sums
them at `summary()` (every 1,024 of a name are folded into one on their
device: a stack and a sum), so that counting never waits for the device.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler


def recording() -> bool:
    """Whether a torch profiler records: the one check `span` and
    `count` make."""
    return _autograd_profiler._is_profiler_enabled


class _Record:
    __slots__ = ("name", "parent", "root", "thread", "start_ns", "end_ns",
                 "events", "stream")

    def __init__(self, name, parent, thread):
        self.name = name
        self.parent = parent
        self.root = self if parent is None else parent.root
        self.thread = thread
        # None: no card (device time = host time); False: on a card,
        # untimed; else the (start, end) timing events
        self.events = None
        self.end_ns = None
        self.start_ns = time.perf_counter_ns()


class _Recorder:
    """Closed span records, counters, and each thread's open spans."""

    def __init__(self):
        self.lock = threading.Lock()
        self.records = []
        self.counters = {}
        self.open = {}

    def enter(self, name: str, device_time: bool) -> _Record:
        thread = threading.get_ident()
        with self.lock:
            stack = self.open.setdefault(thread, [])
            parent = stack[-1] if stack else None
            if parent is None:
                # autograd runs a card's backward on a thread of its own
                # while the caller waits inside its span: that span is
                # the parent when one other thread has spans open
                others = [s[-1] for t, s in self.open.items()
                          if s and t != thread]
                parent = others[0] if len(others) == 1 else None
            rec = _Record(name, parent, thread)
            stack.append(rec)
        if not torch.cuda.is_initialized():
            return rec
        if not device_time:
            rec.events = False
        elif not torch.cuda.is_current_stream_capturing():
            # both events on the stream the span starts on (fetching it
            # costs as much as recording an event)
            rec.stream = torch.cuda.current_stream()
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record(rec.stream)
        return rec

    def exit(self, rec: _Record) -> None:
        if rec.events:
            rec.events[1].record(rec.stream)
        rec.end_ns = time.perf_counter_ns()
        with self.lock:
            self.open[rec.thread].remove(rec)
            self.records.append(rec)

    def add(self, name: str, value) -> None:
        """A host int is added at once; a 0-d tensor is kept and summed
        on its device with the others when there are many (or at
        summary())."""
        with self.lock:
            total, kept = self.counters.get(name, (0, []))
            if isinstance(value, torch.Tensor):
                kept.append(value)
                if len(kept) >= _FOLD:
                    kept[:] = [torch.stack(kept).sum()]
            else:
                total += value
            self.counters[name] = (total, kept)

    def totals(self) -> dict:
        with self.lock:
            return {name: total + sum(v.item() for v in kept)
                    for name, (total, kept) in self.counters.items()}


_RECORDER = _Recorder()
# counted tensors kept a counter before they are summed into one
_FOLD = 1024


class _Off:
    """A span while nothing records: one shared object a name."""

    __slots__ = ("name", "device_time")

    def __init__(self, name: str, device_time: bool):
        self.name = name
        self.device_time = device_time

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _decorated(self.name, self.device_time, fn)


class _On:
    """A span while a profiler records."""

    __slots__ = ("name", "device_time", "_range", "_rec")

    def __init__(self, name: str, device_time: bool):
        self.name = name
        self.device_time = device_time

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._rec = _RECORDER.enter(self.name, self.device_time)
        return self._rec

    def __exit__(self, *exc):
        _RECORDER.exit(self._rec)
        self._range.__exit__(*exc)
        return False

    def __call__(self, fn):
        return _decorated(self.name, self.device_time, fn)


_OFF = {}


def span(name: str, device_time: bool = False):
    """A named range of the program: `with span("bin.sort"): ...`, or
    `@span("mesh.raster")` on a function (checked at each call).
    `device_time=True` times the device between its ends with CUDA
    events, for a reading of its device ms; the trace shows every span's
    device range either way."""
    if not _autograd_profiler._is_profiler_enabled:
        off = _OFF.get((name, device_time))
        if off is None:
            off = _OFF[(name, device_time)] = _Off(name, device_time)
        return off
    return _On(name, device_time)


def _decorated(name: str, device_time: bool, fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with span(name, device_time):
            return fn(*args, **kwargs)
    return run


def count(name: str, value) -> None:
    """Add `value`, an int or a 0-d tensor, to the counter `name`, while
    a profiler records. Not inside a CUDA-graph capture, where a tensor
    holds no value yet. A counted tensor must not be written
    afterwards."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    if isinstance(value, torch.Tensor):
        if value.dim():
            raise ValueError(f"count({name!r}): a tensor of shape "
                             f"{tuple(value.shape)}, not 0-d")
        if value.is_cuda and torch.cuda.is_current_stream_capturing():
            return
        value = value.detach()
    _RECORDER.add(name, value)


def summary() -> dict:
    """{"spans": {name: {"calls", "roots", "host_ms", "self_host_ms",
    "device_ms"}}, "counters": {name: value}} of what was recorded since
    the last reset(). Self host ms is a span's duration less its child
    spans' (choosing-metrics' self time). Device ms is the time between a
    span's timing events; off a card, or inside a CUDA-graph capture, its
    host time; None for a span on a card made without `device_time`."""
    with _RECORDER.lock:
        records = list(_RECORDER.records)
    if any(r.events for r in records):
        torch.cuda.synchronize()
    children = collections.defaultdict(int)
    for r in records:
        if r.parent is not None:
            children[id(r.parent)] += r.end_ns - r.start_ns
    spans = {}
    for r in records:
        s = spans.setdefault(r.name, {"calls": 0, "roots": 0, "host_ms": 0.0,
                                      "self_host_ms": 0.0, "device_ms": 0.0})
        host = (r.end_ns - r.start_ns) / 1e6
        s["calls"] += 1
        s["roots"] += r.parent is None
        s["host_ms"] += host
        s["self_host_ms"] += max(0.0, host - children[id(r)] / 1e6)
        if r.events is False or s["device_ms"] is None:
            s["device_ms"] = None
        else:
            s["device_ms"] += (r.events[0].elapsed_time(r.events[1])
                               if r.events else host)
    return {"spans": spans, "counters": _RECORDER.totals()}


def reset() -> None:
    """Forget every closed span record and counter."""
    with _RECORDER.lock:
        _RECORDER.records.clear()
        _RECORDER.counters.clear()


@contextlib.contextmanager
def trace(log_dir: str, schedule=None):
    """Profile the block and write <log_dir>/trace_<pid>_<ns>.json, a
    Chrome trace (chrome://tracing, ui.perfetto.dev), and beside it
    trace_<pid>_<ns>.summary.json, the summary() of what it recorded.
    Yields the profiler; after the block `prof.trace_path`,
    `prof.summary_path` and `prof.summary` hold both. With a
    `torch.profiler.schedule`, the block steps the profiler
    (`prof.step()`) and only the schedule's active steps are recorded,
    spans and counters too; the schedule has to reach one."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with profile(activities=activities, schedule=schedule) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    stem = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}")
    prof.trace_path = stem + ".json"
    prof.export_chrome_trace(prof.trace_path)
    prof.summary = summary()
    prof.summary_path = stem + ".summary.json"
    with open(prof.summary_path, "w") as fh:
        json.dump(prof.summary, fh, indent=1)


def device_rows(prof) -> list:
    """The rows of `prof.key_averages()` that are the card's own activity
    (kernels, copies, sets), with self time: not the device ranges that
    the profiler adds for `record_function` ranges such as the spans
    (`gpu_user_annotation`), which cover the activity inside them and
    would count it again in a sum."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation and e.self_device_time_total > 0]
