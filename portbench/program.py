"""The program's side of a cell: the benchmark's inputs handed to the
port as its own types. Only this file and the entries import the port.
"""

from __future__ import annotations

import torch


def render_config(config: dict):
    from robosimgs_tpu_torch.render.config import RenderConfig
    r = config["render"]
    return RenderConfig(**r["semantics"], **r["binning"])


def reference_render(config: dict) -> dict:
    """The semantic constants the reference composites by."""
    return dict(config["render"]["semantics"])


def gaussians(params: dict):
    from robosimgs_tpu_torch.core.types import Gaussians
    return Gaussians(**params)


def camera(cam: dict, device):
    from robosimgs_tpu_torch.core.camera import Camera
    eye, target, up, fov, w, h = cam["look_at"]
    return Camera.look_at(eye, target, up, fov, w, h, device=device)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
