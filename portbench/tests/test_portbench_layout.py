"""BENCHMARK.json against its files, and the import rules."""

import ast
import json
import re

import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    w, c, config, traffic, limits = harness.resolve(BENCH, cell)
    assert (ROOT / "portbench" / "entries" / f"{traffic['entry']}.py").is_file()
    assert set(config["reduced"]) == set(c["reduced"])
    assert limits
    for trace in (False, True):
        for m in harness.metrics_of(BENCH, cell, trace):
            assert callable(harness.metric_reader(m["name"]).read)
    assert any(m["name"] == "setup_s"
               for m in harness.metrics_of(BENCH, cell, False))
    assert len(harness.metrics_of(BENCH, cell, False)) >= 2
    assert harness.metrics_of(BENCH, cell, True)


def test_names_units_and_keys():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["unit"] == "%" or not m["name"].endswith("roofline")
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _top(name):
    return name.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "portbench").rglob("*.py"))
    assert files
    for f in files:
        tops = {_top(m) for m in _imports(f)}
        assert not tops & {"jax", "jaxlib", "flax", "robosimgs_tpu"}, f


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "portbench" / "reference").rglob("*.py"))
    assert len(files) >= 4
    for f in files:
        for m in _imports(f):
            assert _top(m) != "robosimgs_tpu_torch", (f, m)
            if _top(m) == "portbench":
                assert m.startswith("portbench.reference"), (f, m)


def test_whole_names_tell_the_port_from_the_jax_package():
    import sys
    sys.modules.setdefault("robosimgs_tpu_torch_probe_only", sys)
    try:
        assert "robosimgs_tpu" not in harness.forbidden_modules()
    finally:
        del sys.modules["robosimgs_tpu_torch_probe_only"]


def test_a_family_shares_one_reader_and_a_whole_name_wins(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "fam.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    (tmp_path / "metrics" / "fam.frame.py").write_text(
        "def read(ctx):\n    return 2.0\n")
    assert harness.metric_reader("fam.train", tmp_path).read({}) == 1.0
    assert harness.metric_reader("fam.frame", tmp_path).read({}) == 2.0
    assert (harness.metric_reader("mfu.train").__file__
            == harness.metric_reader("mfu.frame").__file__)


def test_a_listed_metric_that_reads_nothing_is_named():
    cell = "staged1m-train"
    listed = [m["name"] for m in harness.metrics_of(BENCH, cell, True)]
    read = {n: {"value": 1.0, "unit": "%"} for n in listed
            if n != "bwd_roofline.train"}
    assert harness.missing_metrics(BENCH, cell, True, read) == [
        "bwd_roofline.train"]
    read["bwd_roofline.train"] = {"value": 1.0, "unit": "%"}
    assert harness.missing_metrics(BENCH, cell, True, read) == []
