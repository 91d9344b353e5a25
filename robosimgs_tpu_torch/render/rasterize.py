"""Public rasterization API.

rasterize(gaussians, camera) -> {rgb, alpha, depth}, on the device of
the gaussians' tensors.

impl:
  "reference" — plain-torch exact path
  "tiled"     — tile-binned path through the compositing kernel
  "auto"      — "tiled" for CUDA tensors, else "reference"
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.core.types import Gaussians
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.project import project
from robosimgs_tpu_torch.render.reference import composite_reference
from robosimgs_tpu_torch.render.tiled import composite_tiled
from robosimgs_tpu_torch.utils.profiling import span


@span("render.rasterize")
def rasterize(
    gaussians: Gaussians,
    camera: Camera,
    cfg: RenderConfig = RenderConfig(),
    sh_degree: Optional[int] = None,
    background: Optional[torch.Tensor] = None,
    impl: str = "auto",
    return_stats: bool = False,
) -> Dict[str, torch.Tensor]:
    """return_stats: the tiled path adds its binning's BinStats under
    "stats" (truncated Gaussians, overflowed tiles); the reference path
    bins nothing and truncates nothing, so it adds none."""
    if impl == "auto":
        impl = "tiled" if gaussians.device.type == "cuda" else "reference"

    proj = project(gaussians, camera, cfg, sh_degree=sh_degree)
    if impl == "reference":
        return composite_reference(proj, camera.width, camera.height, cfg, background)
    elif impl == "tiled":
        return composite_tiled(proj, camera.width, camera.height, cfg, background,
                               return_stats=return_stats)
    raise ValueError(f"unknown impl {impl!r}")
