"""The readers of the program's spans and counters (portbench/spans.py;
their entries in BENCHMARK.json and, those that wait, in portbench/
spans.json): a traced small run of each cell reads every one listed for
it, and a span the program no longer records under its name is named by
`missing_metrics`."""

import json

import pytest

from portbench import harness, spans
from portbench.tests import small

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
SPAN_SOURCES = ("program_span", "program_counter")
LISTED = [m for m in BENCH["per_layer"] if m["source"] in SPAN_SOURCES]
WAITING = json.loads((harness.HERE / "spans.json").read_text())["per_layer"]
ENTRIES = LISTED + WAITING


def _cell(name: str) -> harness.Cell:
    """The small cell, its benchmark given the entries that wait too."""
    c = small.cell(name, trace=True)
    c.bench = {**c.bench, "per_layer": c.bench["per_layer"] + WAITING}
    return c


def _listed(c: harness.Cell) -> set:
    return {m["name"] for m in ENTRIES if c.name in m["workloads"]}


def test_the_entries_fit_the_benchmark():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    listed = {m["name"] for m in BENCH["per_layer"]}
    layers = {m["layer"] for m in BENCH["per_layer"]
              if m["source"] not in SPAN_SOURCES}
    assert {m["name"] for m in LISTED} == {
        "slots_useful.train", "slots_useful.frame", "keys_useful.train",
        "keys_useful.frame", "pose_ms.frame", "host_wait_ms.frame"}
    assert all(m["name"] not in listed for m in WAITING)
    for m in ENTRIES:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SPAN_SOURCES
        assert set(m["workloads"]) <= set(e2e[m["moves"]]["workloads"])
        assert set(m["workloads"]) <= cells
        assert callable(harness.metric_reader(m["name"]).read)
        if m["name"].startswith(("bin_", "slots_", "keys_")):
            assert m["layer"] in layers      # binning's, letter for letter


@pytest.mark.parametrize("name", ["staged1m-train", "staged1m-views",
                                  "rollout200k-mesh", "rollout200k-splats"])
def test_a_traced_run_reads_every_span_metric_listed(name):
    c = _cell(name)
    out = small.run(c)
    assert out["correct"], out["compared"]
    missing = harness.missing_metrics(c.bench, c.name, True, out["metrics"])
    assert not set(missing) & _listed(c)      # the CPU has no kernels
    got = {k: v["value"] for k, v in out["metrics"].items() if k in _listed(c)}
    assert set(got) == _listed(c)
    for k, v in got.items():
        assert v > 0, k
        if k.startswith(("slots_useful", "keys_useful")):
            assert v <= 100.0, k


def test_a_renamed_span_is_named(monkeypatch):
    from robosimgs_tpu_torch.render import binning
    real = binning.span
    monkeypatch.setattr(binning, "span", lambda name, **kw: real(
        "bin.row_sort" if name == "bin.compact" else name, **kw))
    c = _cell("staged1m-views")
    out = small.run(c)
    missing = harness.missing_metrics(c.bench, c.name, True, out["metrics"])
    assert set(missing) & _listed(c) == {"bin_compact_ms.frame"}


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    from robosimgs_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "summary")
    ctx = {"trace": {"units": 1}}
    assert spans.summary(ctx) is None
    assert spans.ms_per_unit(ctx, ("bin.compact",)) is None
    assert spans.share(ctx, "bin.slots_kept", "bin.slots") is None
    assert spans.summary({"trace": None}) is None


def test_a_span_without_device_time_reads_no_device_ms():
    ctx = {"trace": {"units": 2}, "spans": {"counters": {}, "spans": {
        "a": {"host_ms": 3.0, "device_ms": None},
        "b": {"host_ms": 1.0, "device_ms": 5.0}}}}
    assert spans.ms_per_unit(ctx, ("a",)) is None
    assert spans.ms_per_unit(ctx, ("a", "b")) is None
    assert spans.ms_per_unit(ctx, ("b",)) == 2.5
    assert spans.ms_per_unit(ctx, ("a", "b"), "host_ms") == 2.0
