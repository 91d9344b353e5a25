"""The scenes and the timer that the port's kernel measurements share:
chip_smoke.py, tools/kernel_ab.py and tests/test_torch_cuda.py build
their cases from here, so they check and time the same work.

The bench workload is the JAX package's bench.py render (100k random
Gaussians, SH degree 3, extent 1.5, 256x256, look_at([4, 0.5, 1.2] -> 0,
60 deg), K=384, M=10, bbox 12, two-tier 4/0.15), drawn from
torch.Generator seed 0.
"""

from __future__ import annotations

import math

import torch

from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.core.types import Gaussians
from robosimgs_tpu_torch.render.config import RenderConfig

BENCH_GAUSSIANS = 100_000
BENCH_RES = 256


def bench_config() -> RenderConfig:
    return RenderConfig(tile_capacity=384, max_tiles_per_gaussian=10,
                        bbox_tiles_per_gaussian=12, two_tier_split=4,
                        two_tier_spill_frac=0.15)


def bench_scene(device, n: int = BENCH_GAUSSIANS):
    """(Gaussians, camera, RenderConfig) of the bench workload."""
    g = Gaussians.random(torch.Generator().manual_seed(0), n, sh_degree=3,
                         extent=1.5, device=device)
    cam = Camera.look_at([4.0, 0.5, 1.2], [0, 0, 0], [0, 0, 1], 60.0,
                         BENCH_RES, BENCH_RES, device=device)
    return g, cam, bench_config()


def orbit_views(g: Gaussians, device):
    """[(camera, RenderConfig)] of the render CLI's two 640x480 orbit views
    of g, with the CLI's default RenderConfig (K=1024)."""
    from robosimgs_tpu_torch.cli.render import orbit_cameras
    return [(c, RenderConfig())
            for c in orbit_cameras(g, 2, 60.0, 640, 480, device=device)]


def saturated_scene(device, n: int = 256):
    """n near-opaque splats stacked on the corner the four tiles of a 32x32
    view share (the JAX package's saturated-gradient regression scene,
    tests/test_tiled.py::test_saturated_pixel_gradients_nonzero, with
    wider splats): the middle pixels saturate within the first 16-splat
    groups, the image corners do not. (Gaussians, camera, RenderConfig)."""
    g = Gaussians.random(torch.Generator().manual_seed(0), n, sh_degree=1,
                         device=device)
    means = torch.zeros((n, 3))
    means[:, 0] = torch.linspace(-0.01, 0.01, n)
    g = g.replace(means=means.to(device),
                  log_scales=torch.full((n, 3), math.log(0.5), device=device),
                  logit_opacities=torch.full((n,), 6.0, device=device))
    cam = Camera.look_at([2.5, 0.0, 0.0], [0, 0, 0], [0, 0, 1], 45.0, 32, 32,
                         device=device)
    return g, cam, RenderConfig(tile_capacity=384)


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean ms of fn over reps calls on the current CUDA stream (CUDA
    events), after warmup calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps
