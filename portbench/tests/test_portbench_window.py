"""The training window's bookkeeping (each episode's wall, ended by a
synchronise, in "episode_s") and the two readings of a step's time:
train_step_ms over the whole window, median_step_ms.train of its median
episode."""

import types

import pytest

from portbench import harness
from portbench.tests import small


def _read(name: str, win: dict):
    return harness.metric_reader(name).read({"window": win})


@pytest.fixture(scope="module")
def train():
    c = small.cell("staged1m-train", seconds=2.0)
    entry = harness.entry_module(c.traffic)
    return c, entry, entry.setup(c)


def test_the_episodes_add_up_to_the_window(train):
    c, entry, st = train
    win = entry.window(st, c.seconds)
    eps = win["episode_s"]
    assert len(eps) >= 1
    assert win["units"] == len(eps) * win["episode_steps"]
    assert win["episode_steps"] == c.traffic["episode"]
    assert all(e > 0 for e in eps)
    # the loop's own overhead: a clock read and a few additions
    assert sum(eps) <= win["wall_s"] <= sum(eps) + 1e-3
    # the window stops at the first episode that ends past its seconds
    assert sum(eps[:-1]) < c.seconds <= sum(eps)
    assert min(eps) <= _read("median_step_ms.train", win) * 1e-3 \
        * win["episode_steps"] <= max(eps)


def test_the_window_stops_at_the_first_episode_past_its_seconds(
        train, monkeypatch):
    """On a clock that reads one second more at each read, every episode
    lasts a second, whatever the machine's speed."""
    c, entry, st = train
    reads = iter(range(10 ** 6))
    monkeypatch.setattr(entry, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(reads))))
    win = entry.window(st, 2.5)
    assert win["episode_s"] == [1.0, 1.0, 1.0]
    assert win["units"] == 3 * c.traffic["episode"]
    assert win["attempted"] == win["units"] and win["failed"] == 0
    assert _read("median_step_ms.train", win) == pytest.approx(
        1e3 / c.traffic["episode"])


def test_one_slow_episode_moves_the_mean_and_not_the_median():
    steady = {"episode_s": [3.75] * 13, "episode_steps": 100,
              "units": 1300, "wall_s": 3.75 * 13}
    slow = dict(steady, episode_s=[3.75] * 12 + [11.25],
                wall_s=3.75 * 12 + 11.25)
    for win in (steady, slow):
        assert _read("median_step_ms.train", win) == pytest.approx(37.5)
    assert _read("train_step_ms", steady) == pytest.approx(37.5)
    assert _read("train_step_ms", slow) == pytest.approx(
        37.5 * (12 + 3) / 13)


def test_a_window_without_episodes_has_no_median():
    win = {"units": 10, "wall_s": 1.0, "latencies_s": [0.1] * 10}
    assert _read("median_step_ms.train", win) is None
    assert _read("frame_ms", win) == pytest.approx(100.0)
