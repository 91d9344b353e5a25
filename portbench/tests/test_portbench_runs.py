"""Whole runs of every cell at a size the CPU holds (the program's plain
kernel versions stand in for the CUDA ones): a sound run is correct, and
a run with the timed path broken underneath is not. And a cell, traffic
mix and per-layer metric added as new files and entries alone."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests import small

CELLS = ["staged1m-train", "staged1m-views", "rollout200k-mesh",
         "rollout200k-splats"]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = small.run(small.cell(name, trace=name != "staged1m-train"))
    assert out["correct"], out["compared"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-2:] == ["compared", "_checks"]
    assert "setup_s" in out["metrics"] or out["breakdown"] is not None


def test_a_step_that_returns_its_state_unchanged_is_caught(monkeypatch):
    from robosimgs_tpu_torch.train import trainer as tr
    real = tr.make_train_step

    def unchanged(cfg, impl):
        step = real(cfg, impl)

        def run(state, *a, **k):
            _, metrics = step(state, *a, **k)
            return dataclasses.replace(state, step=state.step + 1), metrics
        return run
    monkeypatch.setattr(tr, "make_train_step", unchanged)
    out = small.run(small.cell("staged1m-train"))
    assert not out["correct"]
    assert out["compared"]["grad_gap"]["value"] == pytest.approx(1.0)


def test_a_fault_of_warmed_calls_alone_is_caught(monkeypatch):
    """Steps that go wrong only once set-up's episode has run (as a cache
    or a reused buffer would) fail the readings taken after the window."""
    from robosimgs_tpu_torch.train import trainer as tr
    real = tr.make_train_step
    calls = [0]

    def late(cfg, impl):
        step = real(cfg, impl)

        def run(state, *a, **k):
            calls[0] += 1
            new, metrics = step(state, *a, **k)
            if calls[0] > small.TRAFFIC["episode"]:
                new = dataclasses.replace(state, step=state.step + 1)
            return new, metrics
        return run
    monkeypatch.setattr(tr, "make_train_step", late)
    out = small.run(small.cell("staged1m-train"))
    assert not out["correct"]
    assert out["compared"]["grad_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_caught(monkeypatch):
    from robosimgs_tpu_torch.train import trainer as tr
    real = tr.photometric_loss

    def half(pred, target, lam=0.2):
        h = pred.shape[0] // 2
        return real(pred[:h], target[:h], lam)
    monkeypatch.setattr(tr, "photometric_loss", half)
    out = small.run(small.cell("staged1m-train"))
    assert not out["correct"]


def _shifted(fn, key):
    def run(*a, **k):
        out = fn(*a, **k)
        out[key] = torch.roll(out[key], 1, dims=0)
        return out
    return run


def test_an_altered_view_is_caught(monkeypatch):
    import importlib
    mod = importlib.import_module("robosimgs_tpu_torch.render.rasterize")
    monkeypatch.setattr(mod, "rasterize", _shifted(mod.rasterize, "rgb"))
    out = small.run(small.cell("staged1m-views"))
    assert not out["correct"]


@pytest.mark.parametrize("name", ["rollout200k-mesh", "rollout200k-splats"])
def test_an_altered_frame_is_caught(monkeypatch, name):
    from robosimgs_tpu_torch.scenegen import rollout as mod
    monkeypatch.setattr(mod, "render_composite",
                        _shifted(mod.render_composite, "rgb"))
    out = small.run(small.cell(name))
    assert not out["correct"]


DRIVER = """
import json, sys, time
from portbench import harness
from portbench.tests import small
c = small.cell("tiny-views", trace=True, root=harness.ROOT)
out = harness.run_cell(c, time.perf_counter())
out.pop("_checks")
print(json.dumps({"root": str(harness.ROOT), **out}))
"""


def test_a_cell_is_added_with_new_files_and_entries_alone(tmp_path):
    root = harness.ROOT
    shutil.copytree(root / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    os.symlink(root / "robosimgs_tpu_torch", tmp_path / "robosimgs_tpu_torch")
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    pb = tmp_path / "portbench"
    config = json.loads((pb / "configs" / "staged1m.json").read_text())
    config = small.merged(config, {"scene": {"n": 1500, "sh_degree": 1},
                                     "cameras": {"count": 3}})
    (pb / "configs" / "tiny.json").write_text(json.dumps(config))
    (pb / "traffic" / "views-two.json").write_text(json.dumps(
        {"entry": "rasterize", "checked": 2, "profile_frames": 3}))
    (pb / "limits" / "tiny-views.json").write_text(json.dumps(
        {"rgb_rms": 1e-3, "alpha_rms": 1e-3, "depth_rms": 1e-3}))
    (pb / "metrics" / "units.frame.py").write_text(
        "def read(ctx):\n    return ctx['trace']['units']\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "a test",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-views", "config": "tiny",
                               "traffic": "views-two", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "units.frame", "unit": "frames",
                               "better": "higher", "source":
                               "program_counter", "layer": "a test",
                               "moves": "frame_ms",
                               "workloads": ["tiny-views"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("frame_ms", "frame_p95_ms"):
            m["workloads"].append("tiny-views")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p: p.read_bytes() for p in before}
    assert after == before          # nothing that was there changed
    env = {**os.environ, "PYTHONPATH": str(tmp_path)}
    res = subprocess.run([sys.executable, "-c", DRIVER], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["root"] == str(tmp_path)
    assert out["correct"], out["compared"]
    assert out["metrics"]["units.frame"]["value"] == small.TRAFFIC["profile_frames"]


def test_the_command_refuses_without_a_card_or_the_program(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    cmd = [sys.executable, "portbench/run.py", "--workload",
           "staged1m-views", "--seed", str(2 ** 31 + 3), "--seconds", "1",
           "--trace", "0"]
    res = subprocess.run(cmd, cwd=harness.ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
    shutil.copytree(harness.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    res = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
