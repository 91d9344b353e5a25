"""Per-Gaussian projection: world 3D Gaussians -> screen-space splats.

The EWA projection stage of the 3DGS rasterizer: camera transform,
perspective Jacobian with FOV-limit clamping, 2D covariance + low-pass
blur, conic inversion, radius/culling, and SH color evaluation. O(N)
elementwise torch work; autograd supplies its backward.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.core.math3d import (camera_covariance_components,
                                             rotmat_components)
from robosimgs_tpu_torch.core.sh import eval_sh
from robosimgs_tpu_torch.core.types import Gaussians
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class Projected:
    """Screen-space splats, one slot per Gaussian (capacity-static).

    means2d: (N, 2) pixel coords (pixel centers at integer coordinates).
    conics:  (N, 3) (a, b, c) of the inverse 2D covariance.
    depths:  (N,)   camera-space z.
    radii:   (N,)   float pixel radius (0 where culled).
    colors:  (N, 3) SH-evaluated RGB.
    opacities: (N,) activated opacity.
    valid:   (N,)   bool — alive, in front of camera, invertible, on screen.
    abs_probe: optional (N, 2) zeros whose gradient will carry the
      absgrad densification signal (rides pack16 columns 7/15).
    normals: optional (N, 3) camera-space unit splat normals when
      RenderConfig.render_normals is on.
    """

    means2d: torch.Tensor
    conics: torch.Tensor
    depths: torch.Tensor
    radii: torch.Tensor
    colors: torch.Tensor
    opacities: torch.Tensor
    valid: torch.Tensor
    abs_probe: Optional[torch.Tensor] = None
    normals: Optional[torch.Tensor] = None


@span("splat.project")
def project(
    gaussians: Gaussians,
    camera: Camera,
    cfg: RenderConfig = RenderConfig(),
    sh_degree: int | None = None,
    means2d_offset: torch.Tensor | None = None,
    tan_half_fov: tuple | None = None,
    abs_probe: torch.Tensor | None = None,
) -> Projected:
    """Project on the device of `gaussians` (the camera is moved there).

    means2d_offset: optional (N, 2) zeros whose gradient exposes the
    per-Gaussian screen-space gradient (the densification signal).

    tan_half_fov: optional (tan_fx, tan_fy) override for the Jacobian
    clamping limits — tile-sharded rendering passes the FULL frame's
    FOV here so a row-strip crop camera projects identically to the
    uncropped one."""
    g = gaussians
    camera = camera.to(g.device)
    if sh_degree is None:
        sh_degree = g.sh_degree

    w2c = camera.w2c
    R_cw = w2c[:3, :3]
    t_cw = w2c[:3, 3]

    # camera transform unrolled to (N,) elementwise f32 math
    mx, my, mz = g.means[:, 0], g.means[:, 1], g.means[:, 2]
    tx = R_cw[0, 0] * mx + R_cw[0, 1] * my + R_cw[0, 2] * mz + t_cw[0]
    ty = R_cw[1, 0] * mx + R_cw[1, 1] * my + R_cw[1, 2] * mz + t_cw[1]
    tz = R_cw[2, 0] * mx + R_cw[2, 1] * my + R_cw[2, 2] * mz + t_cw[2]
    in_front = tz > cfg.near
    tz_safe = torch.where(in_front, tz, torch.ones_like(tz))

    c00, c01, c02, c11, c12, c22 = camera_covariance_components(
        g.normalized_quats(), g.scales(), R_cw)

    # Perspective Jacobian with the reference's 1.3x-FOV clamping of the
    # projected center (stabilizes far-off-screen Gaussians).
    tan_fx, tan_fy = tan_half_fov if tan_half_fov is not None else camera.tan_half_fov
    lim_x = 1.3 * tan_fx
    lim_y = 1.3 * tan_fy
    txz = torch.clamp(tx / tz_safe, -lim_x, lim_x)
    tyz = torch.clamp(ty / tz_safe, -lim_y, lim_y)
    fx, fy = camera.fx, camera.fy
    inv_z = 1.0 / tz_safe
    # J = [[fx/z, 0, -fx*x/z^2], [0, fy/z, -fy*y/z^2]]  (rows of 2x3)
    j00 = fx * inv_z
    j02 = -fx * txz * inv_z
    j11 = fy * inv_z
    j12 = -fy * tyz * inv_z

    # cov2d = J C J^T (expanded; J sparse with zeros at j01/j10)
    a_raw = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22)
    b = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    c_raw = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22)
    a = a_raw + cfg.blur
    c = c_raw + cfg.blur

    det = a * c - b * b
    invertible = det > 0.0
    det_safe = torch.where(invertible, det, torch.ones_like(det))
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], -1)

    mid = 0.5 * (a + c)
    lam_max = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.0))
    radius = torch.ceil(cfg.radius_factor * torch.sqrt(torch.clamp_min(lam_max, 0.0)))

    u = fx * tx * inv_z + camera.cx - 0.5
    v = fy * ty * inv_z + camera.cy - 0.5
    means2d = torch.stack([u, v], -1)
    if means2d_offset is not None:
        means2d = means2d + means2d_offset

    on_screen = (
        (u + radius > 0.0) & (u - radius < camera.width - 1)
        & (v + radius > 0.0) & (v - radius < camera.height - 1)
    )
    valid = g.alive & in_front & invertible & on_screen
    radius = torch.where(valid, radius, torch.zeros_like(radius))

    # SH color in the world frame from the camera origin.
    dirs = g.means - camera.origin
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp_min(1e-8)
    sh = torch.cat([g.sh_dc[:, None, :], g.sh_rest], dim=1)
    colors = eval_sh(sh_degree, sh, dirs)

    normals = None
    if cfg.render_normals:
        # splat normal = rotated axis of the SMALLEST scale, camera-space,
        # oriented toward the camera; no gradient through the argmin
        rc = rotmat_components(g.normalized_quats())
        oh = torch.nn.functional.one_hot(
            torch.argmin(g.scales(), dim=-1), 3).to(g.means.dtype)   # (N, 3)
        nw = [rc[i][0] * oh[:, 0] + rc[i][1] * oh[:, 1] + rc[i][2] * oh[:, 2]
              for i in range(3)]
        nc = [R_cw[i, 0] * nw[0] + R_cw[i, 1] * nw[1] + R_cw[i, 2] * nw[2]
              for i in range(3)]
        toward = nc[0] * tx + nc[1] * ty + nc[2] * tz > 0.0
        flip = torch.where(toward, -torch.ones_like(tx), torch.ones_like(tx))
        normals = torch.stack(nc, -1) * flip[:, None]

    opacities = g.opacities()
    if cfg.antialiased:
        # mip-splatting opacity compensation: the +blur low-pass
        # enlarges splats; scaling opacity by sqrt(det_raw/det_blurred)
        # keeps their integrated contribution constant
        det_raw = a_raw * c_raw - b * b
        comp = torch.sqrt(torch.clamp_min(det_raw, 0.0)
                          / torch.where(det_safe > 0, det_safe,
                                        torch.ones_like(det_safe)))
        opacities = opacities * comp

    return Projected(
        means2d=means2d,
        conics=conic,
        depths=tz,
        radii=radius,
        colors=colors,
        opacities=opacities,
        valid=valid,
        abs_probe=abs_probe,
        normals=normals,
    )
