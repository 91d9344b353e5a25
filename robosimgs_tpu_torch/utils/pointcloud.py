"""Point-cloud projection / depth-map / mask-transfer utilities.

A port of robosimgs_tpu/utils/pointcloud.py, the upstream RoboSimGS
point utils (`Articulation/utils/point_utils.py`, torch and
torch_scatter there) in plain torch:

  project_pcd     — world -> camera -> pixel coordinates
  unproject_pcd   — pixels + depth -> camera/world points
  depth_map_from_points — z-buffer scatter-min (`scatter_reduce_` with
                    "amin" where the JAX package has `segment_min`)
  sample_mask_at_points — bilinear mask sampling at projected points
                    with optional depth-consistency test (the
                    F.grid_sample role)

Each runs on the device of the points it is given (the camera is moved
there). Cameras follow the package-wide OpenCV/pixel-center conventions
(core/camera.py).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from robosimgs_tpu_torch.core.camera import Camera


def project_pcd(points: torch.Tensor,
                camera: Camera) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N,3) world points -> ((N,2) pixel uv, (N,) camera depth)."""
    camera = camera.to(points.device)
    w2c = camera.w2c
    p = points @ w2c[:3, :3].T + w2c[:3, 3]
    z = p[:, 2]
    zs = torch.where(z > 1e-9, z, torch.ones_like(z))
    u = camera.fx * p[:, 0] / zs + camera.cx - 0.5
    v = camera.fy * p[:, 1] / zs + camera.cy - 0.5
    return torch.stack([u, v], -1), z


def unproject_pcd(uv: torch.Tensor, depth: torch.Tensor, camera: Camera,
                  to_world: bool = True) -> torch.Tensor:
    """(N,2) pixel coords + (N,) depth -> (N,3) points."""
    camera = camera.to(uv.device)
    x = (uv[:, 0] + 0.5 - camera.cx) / camera.fx * depth
    y = (uv[:, 1] + 0.5 - camera.cy) / camera.fy * depth
    cam_pts = torch.stack([x, y, depth], -1)
    if not to_world:
        return cam_pts
    c2w = camera.c2w
    return cam_pts @ c2w[:3, :3].T + c2w[:3, 3]


def depth_map_from_points(points: torch.Tensor, camera: Camera,
                          downscale: int = 2) -> torch.Tensor:
    """Z-buffer depth map from a point cloud via a scatter-min.

    The upstream strategy: z-buffer at 1/downscale resolution then
    nearest-upsample; empty pixels +inf. Invalid points go to a sink bin
    past the image, as in the JAX package. torch.round rounds half to
    even, as jnp.round does."""
    H, W = camera.height, camera.width
    h, w = H // downscale, W // downscale
    uv, z = project_pcd(points, camera)
    ui = torch.round(uv[:, 0] / downscale).to(torch.int64)
    vi = torch.round(uv[:, 1] / downscale).to(torch.int64)
    valid = (z > 1e-9) & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
    flat = torch.where(valid, vi * w + ui, torch.full_like(ui, h * w))
    z_masked = torch.where(valid, z, torch.full_like(z, math.inf))
    depth = torch.full((h * w + 1,), math.inf, dtype=z.dtype, device=z.device)
    depth.scatter_reduce_(0, flat, z_masked, "amin", include_self=True)
    small = depth[: h * w].reshape(h, w)
    return small.repeat_interleave(downscale, 0).repeat_interleave(
        downscale, 1)[:H, :W]


def sample_mask_at_points(
    mask: torch.Tensor,                  # (H, W) float or bool
    points: torch.Tensor,                # (N, 3) world
    camera: Camera,
    depth_map: Optional[torch.Tensor] = None,
    depth_tolerance: float = 0.05,
    threshold: float = 0.5,
) -> torch.Tensor:
    """Bilinearly sample a 2D mask at projected 3D points, returning a
    (N,) bool in-mask flag. With depth_map, points occluded by nearer
    geometry (z > depth + tolerance) are excluded (the upstream
    depth-consistency test)."""
    H, W = mask.shape
    m = mask.to(torch.float32)
    uv, z = project_pcd(points, camera)
    u, v = uv[:, 0], uv[:, 1]
    u0 = torch.floor(u).to(torch.int64)
    v0 = torch.floor(v).to(torch.int64)
    fu = u - u0
    fv = v - v0

    def at(vi, ui):
        inb = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        val = m[vi.clamp(0, H - 1), ui.clamp(0, W - 1)]
        return torch.where(inb, val, torch.zeros_like(val))

    val = ((1 - fu) * (1 - fv) * at(v0, u0) + fu * (1 - fv) * at(v0, u0 + 1)
           + (1 - fu) * fv * at(v0 + 1, u0) + fu * fv * at(v0 + 1, u0 + 1))
    ok = (val > threshold) & (z > 1e-9)
    if depth_map is not None:
        ui = torch.round(u).to(torch.int64).clamp(0, W - 1)
        vi = torch.round(v).to(torch.int64).clamp(0, H - 1)
        ok = ok & (z <= depth_map[vi, ui] + depth_tolerance)
    return ok
