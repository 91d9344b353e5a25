"""The feasibility3m configuration (3M Gaussians on 32-px tiles, the
benchmark's portbench/configs/feasibility3m.json) at a CPU size, and the
cluster forward's walk counter.

(a) `Trainer.run` on 32-px tiles, three steps from the benchmark's start
state, against the plain reference (portbench/reference/train.py): each
step's loss, the first gradient's norm per parameter group and the
change after the three steps.

(b) The forward's `pairs` counter (render/kernels.py::Composite): passed
to the launch only while a profiler records and the tiles run as a
cluster on the card; counted there as `fwd.pairs_walked` and
`fwd.pairs_processed`. The card's tests are marked `cuda` and skip
without a CUDA device (decided in the fixture):

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_feasibility3m.py
"""

import dataclasses
import json
import math
import sys
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import checks, program, scenes  # noqa: E402
from portbench.reference import splats  # noqa: E402
from portbench.reference import train as ref_train  # noqa: E402
from robosimgs_tpu_torch.core.camera import Camera  # noqa: E402
from robosimgs_tpu_torch.core.types import Gaussians  # noqa: E402
from robosimgs_tpu_torch.render import kernels  # noqa: E402
from robosimgs_tpu_torch.render.config import RenderConfig  # noqa: E402
from robosimgs_tpu_torch.render.rasterize import rasterize  # noqa: E402
from robosimgs_tpu_torch.train.data import Frame  # noqa: E402
from robosimgs_tpu_torch.train.optim import OptimConfig  # noqa: E402
from robosimgs_tpu_torch.train.trainer import (TrainConfig,  # noqa: E402
                                               Trainer)
from robosimgs_tpu_torch.utils import profiling  # noqa: E402

CONFIG = json.loads((ROOT / "portbench" / "configs" /
                     "feasibility3m.json").read_text())
FIRST_STEP = 15001
STEPS = 3


def _small_config() -> dict:
    """The configuration at a CPU size: 2,000 Gaussians, two ring views
    of 64x64 (four 32-px tiles each), a tile capacity over the scene's
    size, so that no tile overflows; every other number as configured."""
    c = json.loads(json.dumps(CONFIG))
    c["scene"]["n"] = 2000
    c["cameras"].update(count=2, width=64, height=64)
    c["render"]["binning"]["tile_capacity"] = 2048
    return c


def _train_config(c: dict) -> TrainConfig:
    t = dict(c["train"])
    optim = OptimConfig(**t.pop("optim"))
    t["background"] = tuple(t["background"])
    return TrainConfig(render=program.render_config(c), optim=optim,
                       impl="tiled", **{**t, "log_every": 1})


def test_the_configuration_keeps_the_sources_tiles_and_scene():
    assert CONFIG["render"]["semantics"]["tile_size"] == 32
    assert CONFIG["scene"] == {"n": 3_000_000, "sh_degree": 3,
                               "extent": 1.5}
    assert CONFIG["render"]["binning"]["two_tier_split"] == 0
    assert CONFIG["reduced"] == []
    assert kernels._split_kernel(32 * 32)


def test_three_trainer_steps_on_32px_tiles_match_the_plain_reference():
    """Both sides compute in float32 on the CPU from the same scene and
    targets; they differ by the order of their sums (the program's
    compositing in 128-splat blocks with log-space transmittance and its
    gather's per-Gaussian sum, the reference's chunks and autograd), so
    the gaps are rounding. Over five seeds at this size the loss gap
    read 8.5e-7 to 1.5e-6 and the gradient gap 1.6e-7 to 2.8e-7: the
    tolerances are about seven and ten times those, and hundreds of
    times under what the reference in TF32 reads at the benchmark's size
    (0.067 and 0.054, PERF.md). The change gap read 1.0e-5 to 1.1e-4:
    Adam's first steps (eps 1e-15) move every coordinate by about its
    rate whatever the size of its gradient, so a coordinate whose
    gradient is rounding on one side and 0 or of the other sign on the
    other turns by rounding alone; its tolerance is the benchmark's
    limit, 2e-4, which a step that returns its state unchanged (1) or
    runs in TF32 (7.4e-4 at the 1M scene, PERF.md) exceeds."""
    c = _small_config()
    seed = 2 ** 31 + 11
    params = scenes.random_gaussians(seed, c["scene"]["n"],
                                     c["scene"]["sh_degree"],
                                     c["scene"]["extent"], "cpu")
    cams = scenes.cameras(c["cameras"])
    rc = dict(c["render"]["semantics"])
    rcams = [splats.camera_tensors(cam, "cpu") for cam in cams]
    bg = torch.tensor(c["train"]["background"], dtype=torch.float32)
    colours = scenes.redraw_colours(seed, params)
    targets = [ref_train.render(colours, rcam, rc, bg)["rgb"]
               for rcam in rcams]

    frames = [Frame(camera=Camera.look_at(*cam["look_at"], device="cpu"),
                    image=t.numpy()) for cam, t in zip(cams, targets)]
    trainer = Trainer(_train_config(c), Gaussians(**params), frames)
    trainer.state = dataclasses.replace(trainer.state, step=FIRST_STEP)
    start = trainer.state
    logged = []
    trainer.run(iterations=1, progress=False, on_log=logged.append)
    b1 = trainer.cfg.optim.b1
    first = checks.norms({k: trainer.state.opt_state[k].mu / (1 - b1)
                          for k in ref_train.FIELDS})
    trainer.run(iterations=STEPS - 1, progress=False, on_log=logged.append)
    change = checks.norms({k: getattr(trainer.state.gaussians, k)
                           - getattr(start.gaussians, k)
                           for k in ref_train.FIELDS})
    assert len(logged) == STEPS

    ref = ref_train.train(params, rcams, targets, rc, c["train"],
                          FIRST_STEP, STEPS)
    ref_first = checks.norms(ref["first_grads"])
    ref_change = checks.norms({k: ref["params"][k] - params[k]
                               for k in ref_train.FIELDS})
    loss_gap = checks.loss_gap([float(m["loss"]) for m in logged],
                               ref["losses"])
    grad_gap = checks.leaf_gap(first, ref_first)
    change_gap = checks.leaf_gap(change, ref_change,
                                 skip=checks.quiet_leaves(ref_first))
    assert loss_gap <= 1e-5, loss_gap
    assert grad_gap <= 3e-6, grad_gap
    assert change_gap <= 2e-4, change_gap
    # the steps moved the scene: a step that returns its state unchanged
    # reads a change gap of 1
    assert all(v > 0 for v in change.values())


def test_the_small_views_neither_truncate_nor_overflow():
    c = _small_config()
    g = Gaussians(**scenes.random_gaussians(7, c["scene"]["n"], 3, 1.5,
                                            "cpu"))
    for cam in scenes.cameras(c["cameras"]):
        out = rasterize(g, Camera.look_at(*cam["look_at"], device="cpu"),
                        program.render_config(c), impl="tiled",
                        return_stats=True)
        assert int(out["stats"].truncated_gaussians) == 0
        assert int(out["stats"].overflowed_tiles) == 0


def _on(device_type: str):
    return types.SimpleNamespace(device=torch.device(device_type))


@pytest.mark.parametrize("tile_size", [32, 24, 16, 8])
def test_off_the_recorder_no_walk_counter_is_made(tile_size):
    assert not profiling.recording()
    cfg = RenderConfig(tile_size=tile_size)
    assert kernels._walk_counter(_on("cuda"), cfg) is None
    assert kernels._walk_counter(_on("cpu"), cfg) is None


@pytest.mark.parametrize("tile_size", [16, 8])
def test_one_block_tiles_get_no_walk_counter_while_recording(tile_size):
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        assert profiling.recording()
        assert kernels._walk_counter(_on("cuda"),
                                     RenderConfig(tile_size=tile_size)) is None
        # the plain version on the CPU counts nothing at any tile size
        assert kernels._walk_counter(_on("cpu"),
                                     RenderConfig(tile_size=32)) is None


def _scene(device, n=3000, res=96):
    g = Gaussians.random(torch.Generator().manual_seed(3), n, sh_degree=3,
                         extent=1.5, device=device)
    cam = Camera.look_at([4.0, 0.5, 1.2], [0, 0, 0], [0, 0, 1], 60.0, res,
                         res, device=device)
    return g, cam


@pytest.mark.parametrize("recorded", [False, True])
def test_the_forward_launch_gets_pairs_only_where_counted(monkeypatch,
                                                          recorded):
    """On the CPU no launch gets `pairs`, recorded or not, at 32 px, and
    nothing is counted under `fwd.*`."""
    seen = []
    real = kernels.composite_fwd

    def spy(*a, **k):
        seen.append(k.get("pairs"))
        return real(*a, **k)
    monkeypatch.setattr(kernels, "composite_fwd", spy)
    g, cam = _scene("cpu", n=500, res=64)
    cfg = RenderConfig(tile_size=32, tile_capacity=512)
    profiling.reset()
    if recorded:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]):
            rasterize(g, cam, cfg, impl="tiled")
    else:
        rasterize(g, cam, cfg, impl="tiled")
    assert seen == [None]
    assert not {k for k in profiling.summary()["counters"]
                if k.startswith("fwd.")}
    profiling.reset()


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _recorded(fn):
    profiling.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        out = fn()
        torch.cuda.synchronize()
    counters = profiling.summary()["counters"]
    profiling.reset()
    return out, counters


@pytest.mark.cuda
def test_on_the_card_a_recorded_32px_render_counts_its_walk(device):
    g, cam = _scene(device)
    cfg = RenderConfig(tile_size=32, tile_capacity=1024)
    plain = rasterize(g, cam, cfg, impl="tiled")
    out, counters = _recorded(lambda: rasterize(g, cam, cfg, impl="tiled"))
    walked = counters["fwd.pairs_walked"]
    processed = counters["fwd.pairs_processed"]
    assert 0 < walked <= processed
    for k in ("rgb", "alpha", "depth"):
        assert torch.equal(out[k], plain[k]), k


@pytest.mark.cuda
def test_on_the_card_16px_tiles_count_no_walk(device):
    g, cam = _scene(device)
    cfg = RenderConfig(tile_size=16, tile_capacity=1024)
    _, counters = _recorded(lambda: rasterize(g, cam, cfg, impl="tiled"))
    assert not {k for k in counters if k.startswith("fwd.")}
    assert counters["bin.slots"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size", [32, 16])
def test_on_the_card_a_recorded_step_counts_the_backwards_splits(
        device, tile_size):
    g, cam = _scene(device)
    cfg = RenderConfig(tile_size=tile_size, tile_capacity=1024)
    T = math.ceil(96 / tile_size) ** 2

    def step():
        gg = Gaussians(**{f.name: getattr(g, f.name).detach().requires_grad_(
            getattr(g, f.name).is_floating_point())
            for f in dataclasses.fields(g)})
        out = rasterize(gg, cam, cfg, impl="tiled")
        out["rgb"].sum().backward()
        return gg.means.grad
    grad, counters = _recorded(step)
    assert torch.isfinite(grad).all()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    assert counters["composite.bwd_splits"] == kernels.bwd_splits(
        T, 1024, tile_size ** 2, sms)
