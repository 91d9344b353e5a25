"""The port's span recorder (utils/profiling.py): spans and counters do
nothing while no profiler records; under torch.profiler a tiled
rasterize, training steps and a rollout record their spans with their
parent links, the exported Chrome trace holds each span around the
operations launched inside it, and binning's counters equal what its
own outputs say."""

import json
import threading

import jax  # noqa: F401  (tests import both packages)
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.core.types import Gaussians
from robosimgs_tpu_torch.render.binning import (bin_and_gather_packed,
                                                per_gaussian_cover)
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.mesh_raster import MeshRasterConfig
from robosimgs_tpu_torch.render.project import project
from robosimgs_tpu_torch.render.rasterize import rasterize
from robosimgs_tpu_torch.scenegen.rollout import (ArticulatedObject,
                                                  open_close_trajectory,
                                                  render_rollout)
from robosimgs_tpu_torch.train.data import synthetic_scene
from robosimgs_tpu_torch.train.trainer import TrainConfig, Trainer
from robosimgs_tpu_torch.utils import meshio, profiling
from robosimgs_tpu_torch.utils.profiling import count, span, summary, trace

CFG = RenderConfig(tile_capacity=256, max_tiles_per_gaussian=16)

URDF = """<?xml version="1.0"?>
<robot name="box">
  <link name="body"><visual>
    <geometry><mesh filename="body.glb" scale="1 1 1"/></geometry>
    <material name="m"><color rgba="0.8 0.6 0.4 1.0"/></material>
  </visual></link>
  <link name="lid"><visual>
    <geometry><mesh filename="lid.glb" scale="1 1 1"/></geometry>
  </visual></link>
  <joint name="hinge" type="revolute">
    <parent link="body"/><child link="lid"/>
    <origin xyz="0 0.3 0.15" rpy="0 0 0"/><axis xyz="1 0 0"/>
    <limit lower="0.0" upper="1.57" effort="5" velocity="2"/>
  </joint>
</robot>"""


def _box(sx, sy, sz):
    v = np.array([[x, y, z] for x in (-sx, sx) for y in (-sy, sy)
                  for z in (-sz, sz)], np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return meshio.Mesh(vertices=v, faces=f)


def _scene(n=300, seed=0):
    g = Gaussians.random(torch.Generator().manual_seed(seed), n,
                         sh_degree=1, device="cpu")
    cam = Camera.look_at([3.0, 0.5, 1.0], [0, 0, 0], [0, 0, 1], 55.0, 48,
                         32, device="cpu")
    return g, cam


def _rasterize(tmp_path, cfg=CFG):
    g, cam = _scene()

    def run(n):
        for _ in range(n):
            rasterize(g, cam, cfg, impl="tiled")
    return run


def _train(tmp_path):
    tcfg = TrainConfig(render=CFG, impl="tiled", log_every=100)
    gt, frames = synthetic_scene(0, 60, 2, 32, 32, sh_degree=1, device="cpu")
    with torch.no_grad():
        for f in frames:
            f.image = rasterize(gt, f.camera, CFG,
                                impl="reference")["rgb"].numpy()
    trainer = Trainer(tcfg, gt, frames)
    return lambda n: trainer.run(iterations=n, progress=False)


def _rollout(tmp_path, cfg=CFG, mesh_cfg=MeshRasterConfig()):
    meshio.save_mesh(str(tmp_path / "body.glb"), _box(0.3, 0.3, 0.15))
    meshio.save_mesh(str(tmp_path / "lid.glb"), _box(0.3, 0.3, 0.03))
    (tmp_path / "box.urdf").write_text(URDF)
    obj = ArticulatedObject.from_urdf(str(tmp_path / "box.urdf"))
    g, cam = _scene()
    cams = [cam, Camera.look_at([0.5, 3.0, 1.0], [0, 0, 0], [0, 0, 1], 55.0,
                                48, 32, device="cpu")]

    def run(n):
        traj = open_close_trajectory(obj.model, n)
        return render_rollout(g, [obj], traj, cams, cfg, mesh_cfg,
                              impl="tiled")
    return run


# each makes its inputs and returns a call of n steps, frames or renders
CALLS = {"rasterize": _rasterize, "train_step": _train,
         "render_rollout": _rollout}


@pytest.fixture(autouse=True)
def _empty_recorder():
    profiling.reset()
    yield
    profiling.reset()


class _Ops(TorchDispatchMode):
    """Counts the tensor operations run inside it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_off_spans_and_counts_make_no_record_event_or_operation(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called while no profiler records")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    t = torch.arange(5)
    assert span("a") is span("a")           # one shared no-op a name
    with _Ops() as seen:
        with span("a"):
            with span("b"):
                count("c", t)
                count("d", 3)

        @span("e")
        def f(x):
            return x
        f(1)
    assert seen.ops == []
    assert summary() == {"spans": {}, "counters": {}}


def test_a_launch_range_is_an_operation_placed_where_it_is_entered():
    """`launch_range`, around a kernel launched through ctypes: off, the
    shared no-op; under the profiler, a range of an operation's kind (a
    cpu_op, not a user annotation, so the profiler ties a kernel launched
    inside it to it) whose place is the frame that entered it. A span's
    own range is placed in utils/profiling.py, where the benchmark's
    reading by file would count such a kernel."""
    from torch.profiler import ProfilerActivity, profile
    assert profiling.launch_range("k") is profiling.launch_range("j")

    def launcher():
        with span("outer"), profiling.launch_range("k.launch"):
            torch.zeros(4).add_(1)

    with profile(activities=[ProfilerActivity.CPU], with_stack=True,
                 experimental_config=torch.profiler._ExperimentalConfig(
                     verbose=True)) as prof:
        launcher()
    (rng,) = [e for e in prof.events() if e.name == "k.launch"]
    (outer,) = [e for e in prof.events() if e.name == "outer"]
    assert not rng.is_user_annotation and outer.is_user_annotation
    assert "test_torch_spans.py" in rng.stack[0]
    assert "launcher" in rng.stack[0]
    ours = [f for f in outer.stack if "robosimgs_tpu_torch/" in f]
    assert "utils/profiling.py" in ours[0]
    assert set(summary()["spans"]) == {"outer"}


class _Event:
    """A stand-in for torch.cuda.Event: where and in which order it was
    recorded; 2.5 ms from any start to its end."""
    order = []

    def __init__(self, enable_timing=False):
        assert enable_timing

    def record(self, stream):
        self.stream = stream
        _Event.order.append(self)

    def elapsed_time(self, end):
        assert _Event.order.index(self) < _Event.order.index(end)
        return 2.5


def test_on_a_card_a_span_times_itself_by_two_events_on_its_stream(
        monkeypatch):
    stream = object()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: stream)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda: synced.append(1))
    _Event.order.clear()
    with torch.profiler.profile():
        with span("outer", device_time=True):
            with span("inner", device_time=True):
                with span("untimed"):
                    pass
    assert len(_Event.order) == 4            # none for "untimed"
    assert all(e.stream is stream for e in _Event.order)
    s = summary()["spans"]
    assert synced == [1]                     # once, for every record
    assert s["outer"]["device_ms"] == s["inner"]["device_ms"] == 2.5
    assert s["untimed"]["device_ms"] is None
    assert s["untimed"]["host_ms"] >= 0.0
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)        # a CUDA-graph capture
    profiling.reset()
    with torch.profiler.profile():
        with span("captured", device_time=True):
            count("n", torch.ones(()))
    assert len(_Event.order) == 4
    s = summary()
    assert s["spans"]["captured"]["device_ms"] == pytest.approx(
        s["spans"]["captured"]["host_ms"])
    assert s["counters"] == {"n": 1.0}       # a CPU tensor still counts


def test_a_count_takes_ints_and_0d_tensors_only():
    with torch.profiler.profile():
        count("n", 2)
        count("n", torch.tensor(3))
        with pytest.raises(ValueError, match="not 0-d"):
            count("n", torch.ones(4))
    assert summary()["counters"] == {"n": 5}


class _Row:
    def __init__(self, key, device_type, us, annotation):
        self.key, self.device_type = key, device_type
        self.self_device_time_total = us
        self.is_user_annotation = annotation


def test_device_rows_leave_out_the_spans_device_ranges():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    rows = [_Row("kernel", cuda, 5.0, False),
            _Row("bin.cull", cuda, 9.0, True),      # gpu_user_annotation
            _Row("bin.cull", cpu, 0.0, True),
            _Row("aten::sort", cpu, 5.0, False),
            _Row("Memset", cuda, 1.0, False),
            _Row("idle", cuda, 0.0, False)]

    class Prof:
        def key_averages(self):
            return rows
    assert [r.key for r in profiling.device_rows(Prof())] == ["kernel",
                                                              "Memset"]


def test_a_long_training_run_traces_one_log_interval(tmp_path):
    from robosimgs_tpu_torch.cli.train import traced_run
    gt, frames = synthetic_scene(0, 60, 2, 32, 32, sh_degree=1, device="cpu")
    with torch.no_grad():
        for f in frames:
            f.image = rasterize(gt, f.camera, CFG,
                                impl="reference")["rgb"].numpy()
    runs = {}
    for iterations in (7, 4):                # logs at 0, 2, 4, 6 / 0, 2
        tcfg = TrainConfig(render=CFG, impl="tiled", iterations=iterations,
                           log_every=2)
        trainer = Trainer(tcfg, gt, frames)
        prof = traced_run(trainer, str(tmp_path / str(iterations)))
        assert trainer.state.step == iterations
        events = json.loads(open(prof.trace_path).read())["traceEvents"]
        steps = [e for e in events if e.get("cat") == "user_annotation"
                 and e["name"] == "train.step"]
        runs[iterations] = (prof.summary["spans"], len(steps))
    spans, n_marks = runs[7]
    # steps 3 and 4 (after the second logged step, to the third)
    assert spans["train.step"]["roots"] == n_marks == 2
    assert spans["train.log"]["calls"] == 1
    spans, n_marks = runs[4]                 # short: the whole run
    assert spans["train.step"]["roots"] == n_marks == 4


@pytest.mark.parametrize("call", sorted(CALLS))
def test_without_a_profiler_the_program_records_nothing(call, tmp_path):
    CALLS[call](tmp_path)(2)
    assert summary() == {"spans": {}, "counters": {}}
    assert profiling._RECORDER.records == []


def _records():
    return {r.name: r for r in profiling._RECORDER.records}


def _parent(name):
    p = _records()[name].parent
    return None if p is None else p.name


@pytest.mark.parametrize("call", sorted(CALLS))
def test_under_the_profiler_the_program_records_its_spans(call, tmp_path):
    n = 2
    run = CALLS[call](tmp_path)
    with torch.profiler.profile():
        run(n)
    s = summary()["spans"]
    binning = {"splat.bin", "bin.depth_order", "bin.cull", "bin.compact",
               "bin.key_sort", "bin.gather"}
    if call == "rasterize":
        want = binning | {"render.rasterize", "splat.project",
                          "splat.composite"}
        root, per_root = "render.rasterize", 1
        assert _parent("splat.project") == "render.rasterize"
    elif call == "train_step":
        want = binning | {"train.step", "train.backward", "train.optim",
                          "train.log", "splat.project", "splat.composite",
                          "bin.gather_bwd"}
        root, per_root = "train.step", 1
        assert _parent("train.backward") == "train.step"
        assert _parent("train.optim") == "train.step"
        assert _parent("bin.gather_bwd") == "train.backward"
        assert _parent("train.log") is None        # after the step
        # the forward's and the backward's kernel launches
        assert s["splat.composite"]["calls"] == 2 * n
        assert s["train.log"]["calls"] == 1        # step 0 of 100
    else:
        want = binning | {"rollout.frame", "rollout.pose", "rollout.to_host",
                          "mesh.raster", "mesh.bin", "mesh.read_counts",
                          "splat.project", "splat.composite"}
        root, per_root = "rollout.frame", 2 * 2    # cameras x links
        assert _parent("rollout.pose") == "rollout.frame"
        assert _parent("mesh.raster") == "rollout.frame"
        assert _parent("mesh.bin") == "mesh.raster"
        assert _parent("mesh.read_counts") == "mesh.raster"
        assert s["rollout.to_host"]["roots"] == 1  # one a call
        assert s["rollout.pose"]["calls"] == n
        assert s["mesh.raster"]["calls"] == n * per_root
        per_root = 2                               # cameras
    assert set(s) == want
    assert s[root]["calls"] == s[root]["roots"] == n
    assert s["splat.bin"]["calls"] == n * per_root
    for name in binning - {"splat.bin"}:
        assert s[name]["calls"] == n * per_root, name
        assert _parent(name) == "splat.bin"
        assert _records()[name].root.name == root
    for name, row in s.items():
        assert 0.0 <= row["self_host_ms"] <= row["host_ms"], name
        assert row["device_ms"] == pytest.approx(row["host_ms"])  # CPU
    c = summary()["counters"]
    assert set(c) >= {"bin.slots", "bin.slots_kept", "bin.keys_sorted",
                      "bin.keys_real", "bin.truncated",
                      "bin.overflowed_tiles"}
    assert ("mesh.truncated" in c) == (call == "render_rollout")


def test_the_trace_holds_each_span_around_its_operations(tmp_path):
    run = _rasterize(tmp_path)
    with trace(str(tmp_path / "tr")) as prof:
        run(1)
    events = json.loads(open(prof.trace_path).read())["traceEvents"]
    marks = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation"}
    assert set(marks) == set(prof.summary["spans"])
    ops = [e for e in events if e.get("cat") == "cpu_op"]

    def inside(mark):
        a, b = mark["ts"], mark["ts"] + mark["dur"]
        return {e["name"] for e in ops
                if a <= e["ts"] and e["ts"] + e["dur"] <= b}
    assert "aten::sort" in inside(marks["bin.key_sort"])
    assert "aten::searchsorted" in inside(marks["bin.key_sort"])
    assert "aten::argsort" in inside(marks["bin.depth_order"])
    assert "aten::searchsorted" not in inside(marks["bin.gather"])
    outer, inner = marks["render.rasterize"], marks["bin.cull"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    with open(prof.summary_path) as fh:
        assert json.load(fh) == json.loads(json.dumps(prof.summary))
    assert prof.summary["counters"]["bin.slots"] > 0
    assert summary() == prof.summary           # trace() leaves it read


@pytest.mark.parametrize("kw", [
    dict(max_tiles_per_gaussian=4),
    dict(max_tiles_per_gaussian=6, bbox_tiles_per_gaussian=12),
    dict(max_tiles_per_gaussian=6, bbox_tiles_per_gaussian=12,
         two_tier_split=2, two_tier_spill_frac=0.1),
], ids=["one-tier", "compacted", "two-tier"])
def test_binning_counters_equal_what_its_outputs_say(kw):
    g, _ = _scene(n=600, seed=3)
    g = g.replace(log_scales=g.log_scales + 1.0)   # wide: some truncate
    cam = Camera.look_at([3.0, 0.5, 1.0], [0, 0, 0], [0, 0, 1], 55.0, 128,
                         96, device="cpu")
    cfg = RenderConfig(tile_capacity=32, **kw)
    proj = project(g, cam, cfg)
    w, h = cam.width, cam.height
    with torch.profiler.profile():
        _, _, counts, stats = bin_and_gather_packed(proj, w, h, cfg)
    c = summary()["counters"]
    n, M = g.capacity, cfg.max_tiles_per_gaussian
    Mb = max(cfg.bbox_tiles_per_gaussian, M)
    Ms = cfg.two_tier_split
    if 0 < Ms < M:
        S = min(n, max(128, -(-int(cfg.two_tier_spill_frac * n) // 128)
                       * 128))
        sorted_keys = n * Ms + S * (M - Ms)
    else:
        sorted_keys = n * M
    assert c["bin.slots"] == n * Mb
    assert c["bin.slots_kept"] == int(per_gaussian_cover(proj, w, h, cfg,
                                                         Mb).sum())
    assert c["bin.keys_sorted"] == sorted_keys
    assert c["bin.keys_real"] == int(stats.total_pairs)
    assert c["bin.truncated"] == int(stats.truncated_gaussians) > 0
    assert c["bin.overflowed_tiles"] == int(stats.overflowed_tiles) > 0
    assert int(counts.sum()) <= c["bin.keys_real"] < c["bin.keys_sorted"]


def test_a_truncating_rollout_counts_its_truncation(tmp_path):
    cfg = RenderConfig(tile_capacity=128, max_tiles_per_gaussian=1)
    run = _rollout(tmp_path, cfg, MeshRasterConfig(max_tiles_per_tri=1,
                                                   tile_capacity=4))
    with torch.profiler.profile():
        run(1)
    c = summary()["counters"]
    assert c["bin.truncated"] > 0
    assert c["mesh.truncated"] > 0 and c["mesh.overflowed_tiles"] > 0


def test_spans_nest_by_thread_and_a_decorator_checks_each_call():
    @span("outer")
    def outer():
        with span("inner"):
            pass
        seen = {}

        def work():            # as autograd's thread on a card runs a
            with span("other_thread"):   # backward while the caller waits
                seen["rec"] = _records().get("x")
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()

    outer()                                    # decorated while off
    assert summary()["spans"] == {}
    with torch.profiler.profile():
        outer()
        with span("lone"):
            pass
    s = summary()["spans"]
    assert set(s) == {"outer", "inner", "other_thread", "lone"}
    assert _parent("inner") == _parent("other_thread") == "outer"
    assert _records()["other_thread"].thread != _records()["outer"].thread
    assert s["outer"]["roots"] == s["lone"]["roots"] == 1
    assert s["inner"]["roots"] == 0
    children = s["inner"]["host_ms"] + s["other_thread"]["host_ms"]
    assert s["outer"]["self_host_ms"] == pytest.approx(
        s["outer"]["host_ms"] - children)
    outer()                                    # off again
    assert summary()["spans"]["outer"]["calls"] == 1
    profiling.reset()
    assert summary() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("cli", ["train", "render_rollout"])
def test_the_clis_trace_flag_writes_the_trace_and_prints_the_counters(
        cli, tmp_path, capsys):
    out = tmp_path / "out"
    if cli == "train":
        from robosimgs_tpu_torch.cli import train as mod
        argv = ["--synthetic", "40", "--iterations", "2", "--capacity", "64",
                "--sh-degree", "1", "--tile-capacity", "256", "--impl",
                "tiled", "--device", "cpu", "--output", str(out)]
        root, units = "train.step", 2
    else:
        from robosimgs_tpu_torch.cli import render_rollout as mod
        from robosimgs_tpu_torch.train.io_ply import save_ply
        _rollout(tmp_path)                         # writes the URDF
        save_ply(str(tmp_path / "scene.ply"), _scene()[0])
        argv = ["--scene", str(tmp_path / "scene.ply"), "--urdf",
                str(tmp_path / "box.urdf"), "--steps", "2", "--n-cameras",
                "2", "--width", "48", "--height", "32", "--impl", "tiled",
                "--device", "cpu", "--output", str(out)]
        root, units = "rollout.frame", 2
    mod.main(argv + ["--trace", str(tmp_path / "tr")])
    printed = capsys.readouterr().out
    (line,) = [x for x in printed.splitlines() if x.startswith("counters ")]
    counters = json.loads(line[len("counters "):])
    assert counters["bin.slots"] > 0 and counters["bin.truncated"] >= 0
    (summary_path,) = (tmp_path / "tr").glob("*.summary.json")
    spans = json.loads(summary_path.read_text())["spans"]
    assert spans[root]["roots"] == units
    assert len(list((tmp_path / "tr").glob("trace_*.json"))) == 2
    assert summary_path.name.replace(".summary", "") in printed
