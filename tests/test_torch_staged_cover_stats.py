"""tools/staged_cover_stats.py against the JAX package's
scripts/staged_cover_stats.py on the CPU: the script's main() at
STAGED_N=5000 and STAGED_RES 128 (where the largest survivor cover, 4,
leaves one two-tier option) and 512 (22: six) writes its JSON; the tool
runs on the same jax.random draw and camera (core/convert.py). Every
integer of the script's JSON must be equal (covers, pairs, the largest
per-tile demand, the two-tier options), and the spill fractions too (the
same integer ratios). Then the tool's rollout mode at a small n, and its
self-check."""

import importlib.util
import json
import os
import sys

import jax
import pytest
import torch

from robosimgs_tpu.core.camera import Camera as JCamera
from robosimgs_tpu.core.types import Gaussians as JGaussians

from robosimgs_tpu_torch.core.convert import (camera_from_numpy,
                                              gaussians_from_numpy)
from robosimgs_tpu_torch.tools import staged_cover_stats as scs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 5000
RESES = (128, 512)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_script(name: str):
    saved = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "scripts", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


def jax_stats(tmp_path, res):
    out = tmp_path / "stats.json"
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("STAGED_N", str(N))
        mp.setenv("STAGED_RES", str(res))
        mp.setenv("STAGED_STATS_OUT", str(out))
        load_script("staged_cover_stats").main()
    finally:
        mp.undo()
    with open(out) as fh:
        return json.load(fh)


def draw(res):
    """The script's draw and camera, carried across."""
    g = JGaussians.random(jax.random.PRNGKey(1), N, sh_degree=3, extent=1.5)
    cam = JCamera.look_at([4.0, 0.5, 1.2], [0, 0, 0], [0, 0, 1], 60.0, res,
                          res)
    return (gaussians_from_numpy(jax.device_get(g), "cpu"),
            camera_from_numpy(jax.device_get(cam), "cpu"))


@pytest.mark.parametrize("res", RESES)
def test_cover_stats_match_the_script(tmp_path, res):
    want = jax_stats(tmp_path, res)
    got = scs.cover_stats(*draw(res), chunk=1700)      # several chunks
    for key in ("n", "res", "T", "max_bbox_cover", "max_survivor_cover",
                "total_true_pairs", "max_tile_demand"):
        assert got[key] == want[key], key
    assert got["two_tier_lossless"] == want["two_tier_lossless"]
    assert len(got["two_tier_lossless"]) == min(6, (got[
        "max_survivor_cover"] - 1) // 2)
    assert got["cover_percentiles"]["100"] == got["max_survivor_cover"]


def test_rollout_workload_main(capsys):
    assert scs.main(["--workload", "rollout", "--n", "2000",
                     "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["workload"] == "rollout" and len(res["views"]) == 4
    assert res["max_survivor_cover"] == max(
        v["max_survivor_cover"] for v in res["views"])
    for v in res["views"]:
        assert v["res"] == [640, 480] and v["T"] == 1200
        assert v["max_survivor_cover"] <= v["max_bbox_cover"]


def test_demand_that_misses_pairs_raises(monkeypatch):
    real = scs.tile_demand

    def short(*a, **kw):
        d = real(*a, **kw)
        d[int(d.argmax())] -= 1
        return d

    monkeypatch.setattr(scs, "tile_demand", short)
    with pytest.raises(AssertionError, match="sums to"):
        scs.cover_stats(*draw(128))
