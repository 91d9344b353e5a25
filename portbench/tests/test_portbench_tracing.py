"""The idle share and the attribution, on small recorded traces."""

import torch

from portbench import readers, tracing


def _events():
    k = lambda ts, dur, name="k": {"ph": "X", "cat": "kernel", "ts": ts,
                                   "dur": dur, "name": name}
    host = lambda ts, dur, name: {"ph": "X", "cat": "cpu_op", "ts": ts,
                                  "dur": dur, "name": name}
    return [k(0, 10), k(5, 10), k(40, 5, "composite_fwd_kernel<1>"),
            {"ph": "X", "cat": "gpu_memcpy", "ts": 60, "dur": 20,
             "name": "Memcpy DtoH"},
            host(0, 100, "outer"), host(20, 10, "aten::sort"),
            host(46, 10, "aten::item")]


def test_busy_is_the_union_of_device_intervals():
    busy, spans = tracing.busy(_events())
    # [0, 15] u [40, 45] u [60, 80]: 15 + 5 + 20 us
    assert abs(busy - 40e-6) < 1e-12
    ctx = {"trace": {"busy_s": busy, "window_s": 100e-6}}
    assert abs(readers.idle_share(ctx) - 60.0) < 1e-9
    gaps = tracing.idle_gaps(_events(), spans)
    # the longest gap (15, 40) is under aten::sort, the next (45, 60)
    # under aten::item: the innermost host event at the gap's middle
    assert [g[0] for g in gaps] == ["aten::sort", "aten::item"]
    assert abs(gaps[0][1] - 25e-6) < 1e-12


def test_kernels_and_the_roofline_share():
    kern = tracing.kernels(_events())
    assert kern["composite_fwd_kernel<1>"] == (1, 5e-6)
    ctx = {"trace": {"kernels": kern},
           "work": {"launches": {"fwd": [(67e6 * 2.5, 0)]}}}
    # 2.5 us of float32 work in a 5 us launch: half of the roofline
    assert abs(readers.roofline(ctx, "fwd", "composite_fwd_kernel")
               - 50.0) < 1e-9
    ctx["work"]["launches"]["fwd"] = [(0, 3.35e6 * 4)]
    assert abs(readers.roofline(ctx, "fwd", "composite_fwd_kernel")
               - 80.0) < 1e-9
    assert readers.roofline(ctx, "bwd", "composite_bwd") is None


def test_attribution_by_program_file_with_the_backward():
    from robosimgs_tpu_torch.core.camera import Camera
    from robosimgs_tpu_torch.core.types import Gaussians
    from robosimgs_tpu_torch.render.project import project
    g = Gaussians.random(torch.Generator().manual_seed(0), 200,
                         sh_degree=1, device="cpu")
    cam = Camera.look_at([3.0, 0.0, 0.5], [0, 0, 0], [0, 0, 1], 50.0, 32,
                         32, device="cpu")
    means = g.means.clone().requires_grad_(True)
    with tracing.profiled("cpu") as w:
        for _ in range(2):
            p = project(g.replace(means=means), cam)
            p.means2d.sum().backward()
    rows = tracing.attribute_ops(w["prof"], 2, on_device=False)
    files = {tracing.source_file(r[0]) for r in rows}
    assert "render/project.py" in files
    assert any(r[0].startswith("bwd render/project.py") for r in rows)
    ctx = {"trace": {"rows": rows}}
    ms = readers.layer_ms(ctx, readers.PROJECT)
    assert ms is not None and ms > 0
    assert abs(ms - sum(r[3] for r in rows if tracing.source_file(r[0])
                        in readers.PROJECT)) < 1e-12
    assert readers.layer_ms(ctx, readers.MESH) is None
