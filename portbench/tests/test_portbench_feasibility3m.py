"""feasibility3m-train at a size the CPU holds: the configuration's 32-px
tiles kept, 2,000 Gaussians on 64x64 views, a tile capacity over the
scene's size; the traffic shortened as for every cell (small.TRAFFIC).
A sound run is correct, traced or not, and the control (the reference in
TF32) and the planted fault (half the batch left out) are not."""

import json

import pytest

from portbench import checks, control, harness
from portbench.tests import small

NAME = "feasibility3m-train"
SMALL = {"scene": {"n": 2000}, "cameras": {"width": 64, "height": 64},
         "render": {"binning": {"tile_capacity": 2048}}}


def _cell(trace: bool = False, seed: int = 2 ** 31 + 11) -> harness.Cell:
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    _, _, config, traffic, limits = harness.resolve(bench, NAME)
    traffic = {**traffic, **{k: v for k, v in small.TRAFFIC.items()
                             if k in traffic}}
    return harness.Cell(name=NAME, config=small.merged(config, SMALL),
                        traffic=traffic, limits=limits, seed=seed,
                        seconds=0.5, trace=trace, device="cpu", bench=bench)


def test_the_small_size_keeps_the_tiles():
    c = _cell()
    assert c.config["render"]["semantics"]["tile_size"] == 32
    assert c.config["render"]["binning"]["max_tiles_per_gaussian"] == 16
    assert c.limits["truncated"] == 0


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(trace):
    out = small.run(_cell(trace))
    assert out["correct"], out["compared"]
    assert out["failed"] == 0 and out["attempted"] > 0
    if trace:
        assert "slots_useful.train" in out["metrics"]
    else:
        assert "setup_s" in out["metrics"]


def test_the_control_and_the_fault_fail_where_the_program_passes():
    c = _cell()
    r = control.readings(c, harness.entry_module(c.traffic), 2 ** 31 + 7,
                         True)
    assert all(ok for *_, ok in checks.judged(c.limits, r["program"]))
    for kind in ("control", "half_batch"):
        assert not all(ok for *_, ok in checks.judged(c.limits, r[kind]))
