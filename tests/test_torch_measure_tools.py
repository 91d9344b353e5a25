"""The port's measurement tools (tools/profile_stages.py, k_equiv.py,
staged_lossless.py) on the CPU at a tiny size: 3,000 Gaussians of the
tools' own scenes at 64x64, where the plain versions stand in for the
kernels and the times are the host's. What they check holds at any size:
the JSON keys and their finiteness, profile_stages' stages against the
JAX script's and its binning sub-stages against bin_and_gather_packed
(equal), k_equiv of a K against itself (0 gradient difference),
staged_lossless's zero truncation, its sizing from the draw and its
gate."""

import ast
import json
import math
import re
from pathlib import Path

import pytest
import torch

from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.render.binning import bin_and_gather_packed
from robosimgs_tpu_torch.render.project import project
from robosimgs_tpu_torch.tools import (k_equiv, profile_stages,
                                       staged_lossless, workloads)

N, RES = 3000, 64
JAX_SCRIPT = Path(__file__).parents[1] / "scripts" / "profile_stages.py"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench():
    g, _, _ = workloads.bench_scene("cpu", n=N)
    cam = Camera.look_at([4.0, 0.5, 1.2], [0, 0, 0], [0, 0, 1], 60.0, RES,
                         RES, device="cpu")
    return g, cam


@pytest.fixture(scope="module")
def staged():
    return workloads.staged_scene("cpu", n=N, res=RES)


def _finite(x):
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_finite(v) for v in x)
    return not isinstance(x, float) or math.isfinite(x)


def _jax_stage_names():
    """The stage names of the JAX script's table, its f-string sort name
    as 'sort'."""
    for node in ast.walk(ast.parse(JAX_SCRIPT.read_text())):
        if isinstance(node, ast.For) and isinstance(node.iter, ast.List) \
                and all(isinstance(e, ast.Tuple) for e in node.iter.elts):
            return [e.elts[0].value if isinstance(e.elts[0], ast.Constant)
                    else "sort" for e in node.iter.elts]
    raise AssertionError("no stage table in the JAX script")


def test_profile_stages_names_match_the_jax_script(bench):
    assert [profile_stages.JAX_NAMES.get(s, s)
            for s in profile_stages.STAGES] == _jax_stage_names()
    g, cam = bench
    res = profile_stages.profile_stages(
        g, cam, profile_stages.bench_profile_config(), reps=1)
    assert [re.sub(r"^sort\(\d+k\)$", "sort", k)
            for k in res["stages"]] == list(profile_stages.STAGES)
    for key in ("device", "timer", "n", "res", "K", "M", "T", "stages",
                "step_ops", "step_ops_total_ms"):
        assert key in res, key
    assert res["device"] == "cpu" and res["timer"] == "host clock"
    assert all(v > 0 for v in res["stages"].values())
    assert _finite(res) and json.loads(json.dumps(res)) == res
    # the train step's time attributed: the compositor's backward to the
    # function that composites, the gather's transpose to the binner
    where = {r[0] for r in res["step_ops"]}
    assert any(re.fullmatch(r"bwd render/tiled\.py\(\d+\): "
                            r"composite_from_tiles CompositeBackward", w)
               for w in where), where


@pytest.mark.parametrize("cfg", [
    profile_stages.bench_profile_config(),
    workloads.feasibility_config(),
    profile_stages.bench_profile_config(k=256, m=6, bbox=0, tt=0)],
    ids=["bench", "feasibility", "one_tier_no_bbox"])
def test_profile_stages_binning_equals_bin_and_gather(bench, cfg):
    g, cam = bench
    with torch.no_grad():
        proj = project(g, cam, cfg)
        stages, (geom, feat, sel) = profile_stages.binning_stages(
            proj, RES, RES, cfg)
        pgeom, pfeat, _, _, psel = bin_and_gather_packed(proj, RES, RES, cfg,
                                                         return_sel=True)
    assert [s for s, _ in stages][:3] == ["argsort", "narrow-permute",
                                          "tid-expand"]
    assert torch.equal(sel, psel)
    assert torch.equal(geom, pgeom) and torch.equal(feat, pfeat)


def test_k_equiv_keys_and_a_k_against_itself(bench):
    g, cam = bench
    res = k_equiv.k_equiv(g, cam, k_equiv.parse_ks("1024:0,1024:0,256:0"),
                          reps=1)
    assert res["k_ref"] == 1024 and [r["K"] for r in res["ks"]] == [1024,
                                                                     1024, 256]
    same, low = res["ks"][1], res["ks"][2]
    assert same["max_grad_diff"] == 0.0 and same["psnr"] >= 120.0
    assert same["grad_scale"] > 0.0
    for r in res["ks"][1:]:
        for key in ("psnr", "max_grad_diff", "grad_scale", "step_ms",
                    "gaussians_per_s", "loss", "truncated"):
            assert key in r, key
    assert low["overflowed_tiles"] > 0 and low["max_grad_diff"] > 0.0
    assert _finite(res)


def test_k_equiv_default_ks_are_the_jax_scripts():
    assert k_equiv.parse_ks(k_equiv.DEFAULT_KS) == [(5120, 512), (1024, 0),
                                                    (512, 0), (768, 0)]


def test_staged_lossless_keeps_the_constants_that_fit(staged):
    g, cam = staged
    res = staged_lossless.staged_lossless(g, cam, k_staged=1024, iters=1)
    draw, sized = res["draw"], res["sized"]
    assert sized["M"] == 24 and sized["bbox"] == 28
    assert sized["K_lossless"] == 22016 and "kept" in sized["notes"][0]
    assert draw["max_survivor_cover"] <= draw["max_bbox_cover"] <= 25
    assert all(r["truncated"] == 0 for r in res["renders"].values())
    assert set(res["gate_psnr"]) == {"K2048", "K1024", "K1024 tt12"}
    assert all(v >= 60.0 for v in res["gate_psnr"].values())
    assert [s["name"] for s in res["steps"]] == ["K1024 single", "K512 tt12",
                                                 "K1024 tt12"]
    gc = res["grad_check"]
    assert gc["grad_scale"] > 0.0 and gc["lossless_grad_ms"] > 0.0
    assert gc["transpose_ms"] is None           # measured on a card only
    res.pop("configs")
    assert _finite(res)


def test_staged_lossless_sizes_what_does_not_fit(staged):
    """Constants below this draw's covers and demand, as JAX's 24 / 28 /
    22,016 would be below a wider draw's, are raised to the largest the
    draw and every state of the timed steps reach, and the spill tier
    holds every Gaussian past the split: nothing truncates."""
    g, cam = staged
    draw = staged_lossless.measure_draw(g, cam, split=2)
    assert draw["max_survivor_cover"] > 2 and draw["rows_over_split"] > 0
    res = staged_lossless.staged_lossless(
        g, cam, m=2, bbox=2, k_lossless=512, k_cands=(2048,), k_staged=1024,
        split=2, timed=((1024, True),), iters=1)
    assert res["draw"] == draw
    run = res["over_steps"]["K1024"]
    sized = res["sized"]
    assert sized["M"] == max(draw["max_survivor_cover"],
                             run["max_survivor_cover"])
    assert sized["bbox"] == max(draw["max_bbox_cover"], run["max_bbox_cover"])
    assert sized["K_lossless"] == -(-draw["max_tile_demand"] // 512) * 512
    assert len(sized["notes"]) == 3
    assert sized["spill_frac"] * N > max(draw["rows_over_split"],
                                         run["rows_over_split"])
    assert all(r["truncated"] == 0 for r in res["renders"].values())


def test_measure_steps_follows_the_train_steps(staged):
    """The covers over the steps are those of the states the steps reach:
    the initial state's draw and the later states' (two steps here)."""
    g, cam = staged
    target = torch.zeros((RES, RES, 3))
    run = staged_lossless.measure_steps(g, cam, 1024, 2, 56, target)
    draw = staged_lossless.measure_draw(g, cam)
    for key in ("max_bbox_cover", "max_survivor_cover", "rows_over_split"):
        assert run[key] >= draw[key], key
    with pytest.raises(AssertionError, match="past 2"):
        staged_lossless.measure_steps(g, cam, 1024, 0, 2, target)


def test_staged_lossless_gate_fails_below_60_db(staged):
    """At this tiny size K 384 drops splats a lossless render shows (the
    tiles do not saturate): the gate must fail, not pass quietly."""
    g, cam = staged
    with pytest.raises(AssertionError, match="capacity gates below 60.0"):
        staged_lossless.staged_lossless(g, cam, iters=1)


@pytest.mark.parametrize("tool,args", [
    (profile_stages, ["--reps", "1"]),
    (k_equiv, ["--reps", "1", "--ks", "1024:0,512:0"]),
    (staged_lossless, ["--iters", "1", "--k-cands", "2048",
                       "--k-staged", "1024"])], ids=lambda x: getattr(
                           x, "__name__", "").rpartition(".")[2])
def test_cli_prints_one_json_line(tool, args, capsys):
    assert tool.main(["--n", str(N), "--res", str(RES), "--device", "cpu",
                      *args]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["device"] == "cpu" and res["n"] == N and _finite(res)
