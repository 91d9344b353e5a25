"""Pinhole cameras and coordinate conventions.

Internal convention: **OpenCV** camera frame (+x right, +y down, +z into
the scene). Nerfstudio / OpenGL camera-to-world matrices (+x right,
+y up, -z forward) are converted on ingestion by negating the y and z
basis columns.

Pixel convention: the center of pixel (row i, col j) is at continuous
coordinate (x=j, y=i); projection is u = fx*x/z + cx - 0.5. With
cx = W/2 this matches the reference 3DGS rasterizer's `ndc2Pix`
(((ndc+1)*W - 1)/2) so rendered images are pixel-aligned with it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

# Column-sign flip OpenGL/Nerfstudio <-> OpenCV camera axes.
_GL_TO_CV = np.diag([1.0, -1.0, -1.0]).astype(np.float32)


@dataclasses.dataclass
class Camera:
    """A pinhole camera (or a batch of them: leading batch dims allowed).

    Attributes:
      fx, fy, cx, cy: intrinsics (0-d or (...,) tensors).
      c2w: (..., 4, 4) camera-to-world, OpenCV convention.
      width, height: ints.
    """

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    c2w: torch.Tensor
    width: int
    height: int

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_opencv(K: np.ndarray, c2w: np.ndarray, width: int, height: int,
                    device="cuda") -> "Camera":
        K = np.asarray(K, np.float32)

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        return Camera(fx=t(K[0, 0]), fy=t(K[1, 1]), cx=t(K[0, 2]),
                      cy=t(K[1, 2]), c2w=t(c2w),
                      width=int(width), height=int(height))

    @staticmethod
    def from_opengl(K: np.ndarray, c2w_gl: np.ndarray, width: int, height: int,
                    device="cuda") -> "Camera":
        """From an OpenGL/Nerfstudio-convention camera-to-world matrix."""
        c2w_gl = np.asarray(c2w_gl, np.float32)
        c2w = c2w_gl.copy()
        c2w[..., :3, :3] = c2w_gl[..., :3, :3] @ _GL_TO_CV
        return Camera.from_opencv(K, c2w, width, height, device=device)

    @staticmethod
    def look_at(
        eye: Sequence[float], target: Sequence[float], up: Sequence[float],
        fov_deg: float, width: int, height: int, device="cuda",
    ) -> "Camera":
        """OpenCV-convention camera looking from eye at target."""
        eye = np.asarray(eye, np.float32)
        fwd = np.asarray(target, np.float32) - eye
        fwd = fwd / np.linalg.norm(fwd)
        upv = np.asarray(up, np.float32)
        right = np.cross(fwd, upv)
        right = right / np.linalg.norm(right)
        down = np.cross(fwd, right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
        f = 0.5 * width / np.tan(0.5 * np.deg2rad(fov_deg))
        K = np.array([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1]], np.float32)
        return Camera.from_opencv(K, c2w, width, height, device=device)

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self, fx=self.fx.to(device), fy=self.fy.to(device),
            cx=self.cx.to(device), cy=self.cy.to(device),
            c2w=self.c2w.to(device))

    # -- derived -----------------------------------------------------------

    @property
    def w2c(self) -> torch.Tensor:
        """World-to-camera (..., 4, 4) — inverse of the rigid c2w."""
        R = self.c2w[..., :3, :3]
        t = self.c2w[..., :3, 3]
        Rt = R.transpose(-1, -2)
        top = torch.cat([Rt, -(Rt @ t[..., None])], dim=-1)
        # (0, 0, 0, 1) made on the device: no host copy, so a CUDA graph
        # can capture it
        bottom = torch.cat([torch.zeros_like(t), torch.ones_like(t[..., :1])],
                           dim=-1)[..., None, :]
        return torch.cat([top, bottom], dim=-2)

    @property
    def origin(self) -> torch.Tensor:
        return self.c2w[..., :3, 3]

    @property
    def tan_half_fov(self):
        """(tan(fovx/2), tan(fovy/2))."""
        return 0.5 * self.width / self.fx, 0.5 * self.height / self.fy

    def resized(self, width: int, height: int) -> "Camera":
        sx = width / self.width
        sy = height / self.height
        return dataclasses.replace(
            self, fx=self.fx * sx, fy=self.fy * sy,
            cx=self.cx * sx, cy=self.cy * sy, width=width, height=height,
        )
