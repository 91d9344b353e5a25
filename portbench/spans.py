"""The program's own spans and counters (robosimgs_tpu_torch/utils/
profiling.py) over the profiled window, for the readers of the
`program_span` and `program_counter` metrics.

The recorder records only while a torch profiler records, and a run
profiles once (`tracing.profiled`), so what it holds when the readers
run is the profiled window. The first reader of a run takes its summary
into ctx["spans"] and empties the recorder, so that another run in the
same process starts from nothing. A program without the recorder, or a
span or counter that recorded nothing, reads as None.
"""

from __future__ import annotations


def summary(ctx: dict):
    """The recorder's summary of the run's profiled window, or None."""
    if "spans" not in ctx:
        ctx["spans"] = None if ctx.get("trace") is None else _take()
    return ctx["spans"]


def _take():
    from robosimgs_tpu_torch.utils import profiling
    if not hasattr(profiling, "summary"):
        return None
    out = profiling.summary()
    profiling.reset()
    return out


def ms_per_unit(ctx: dict, names, kind: str = "device_ms"):
    """ms a unit (step or frame) summed over the spans `names`, `kind`
    "device_ms" or "host_ms"; None unless every one of them recorded it
    (on a card, a span's device ms needs its `device_time`)."""
    s = summary(ctx)
    if s is None or not all(n in s["spans"] for n in names):
        return None
    ms = [s["spans"][n][kind] for n in names]
    if None in ms:
        return None
    return sum(ms) / ctx["trace"]["units"]


def share(ctx: dict, part: str, whole: str):
    """100 × counter `part` over counter `whole`, in %; None unless both
    were counted and `whole` is not 0."""
    s = summary(ctx)
    if s is None:
        return None
    c = s["counters"]
    if part not in c or not c.get(whole):
        return None
    return 100.0 * c[part] / c[whole]
