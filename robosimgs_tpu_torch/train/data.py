"""Datasets: Nerfstudio transforms.json scenes and synthetic scenes.

A port of robosimgs_tpu/train/data.py. The transforms.json /
dataparser_transforms.json contract: global or per-frame fl_x/fl_y/cx/cy
intrinsics, per-frame 4x4 `transform_matrix` in OpenGL convention, and
an optional dataparser transform+scale mapping normalized scene
coordinates back to metric world coordinates. Cameras are built on the
`device` the parsers are given; images stay on the host as numpy until
the trainer uploads them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.core.types import Gaussians
from robosimgs_tpu_torch.utils.undistort import (distortion_from_meta,
                                                 undistort_image)


@dataclasses.dataclass
class Frame:
    camera: Camera
    image_path: Optional[str] = None
    image: Optional[np.ndarray] = None  # (H, W, 3) float32 in [0,1]
    # lens distortion of the CAPTURED image — canonical 9-vector
    # (k1, k2, p1, p2, k3, k4, k5, k6, fisheye), utils/undistort.py
    # (4-vectors (k1, k2, p1, p2) accepted); removed at load time so
    # `camera` is a true pinhole
    distortion: Optional[np.ndarray] = None
    # optional metric planar z-depth (H, W) float32, 0 = invalid — the
    # supervision target for TrainConfig.depth_lambda (Nerfstudio's
    # depth_file_path: .npy/.npy.gz/16-bit-mm PNG, or synthetic GT)
    depth_path: Optional[str] = None
    depth: Optional[np.ndarray] = None

    def load(self, background: Sequence[float] = (0.0, 0.0, 0.0)) -> np.ndarray:
        if self.image is not None:
            return self.image
        from PIL import Image

        img = Image.open(self.image_path)
        if (img.width, img.height) != (self.camera.width, self.camera.height):
            # camera was downscaled (parse_transforms_json downscale=N):
            # bring the image to the camera's resolution
            img = img.resize((self.camera.width, self.camera.height),
                             Image.LANCZOS)
        arr = np.asarray(img).astype(np.float32) / 255.0
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, -1)
        if arr.shape[-1] == 4:
            a = arr[..., 3:4]
            arr = arr[..., :3] * a + np.asarray(background, np.float32) * (1 - a)
        arr = arr[..., :3]
        if self.distortion is not None \
                and np.any(np.abs(self.distortion) > 1e-12):
            # normalized-coordinate warp: resolution-independent, so the
            # (possibly downscaled) camera intrinsics are the right ones
            arr = undistort_image(arr, float(self.camera.fx),
                                  float(self.camera.fy),
                                  float(self.camera.cx),
                                  float(self.camera.cy), self.distortion)
        self.image = arr
        return self.image

    def load_depth(self) -> Optional[np.ndarray]:
        """(H, W) float32 planar z-depth at the camera's resolution,
        0.0 on invalid pixels; None when the frame carries no depth."""
        if self.depth is None and self.depth_path is None:
            return None
        if self.depth is None:
            p = self.depth_path
            if p.endswith(".npy.gz"):
                from robosimgs_tpu_torch.utils.nerfstudio import \
                    load_depth_npy_gz

                d = load_depth_npy_gz(p)
            elif p.endswith(".npy"):
                d = np.load(p)
            else:
                from PIL import Image

                im = Image.open(p)
                d = np.asarray(im).astype(np.float32)
                if im.mode in ("I", "I;16"):
                    d = d * 1e-3  # integer PNGs are millimeters (ns export)
            self.depth = np.nan_to_num(
                np.squeeze(d).astype(np.float32), nan=0.0, posinf=0.0)
        d = self.depth
        H, W = self.camera.height, self.camera.width
        if d.shape != (H, W):
            from PIL import Image

            # nearest: interpolating across a depth edge invents surface
            d = np.asarray(Image.fromarray(d, mode="F").resize(
                (W, H), Image.NEAREST), np.float32)
            self.depth = d
        return d


def parse_transforms_json(path: str, downscale: int = 1,
                          device="cuda") -> List[Frame]:
    """Parse a Nerfstudio/instant-ngp transforms.json into Frames."""
    with open(path) as f:
        meta = json.load(f)
    root = os.path.dirname(os.path.abspath(path))
    frames = []
    for fr in meta["frames"]:
        def get(key, default=None):
            return fr.get(key, meta.get(key, default))

        fx, fy = get("fl_x"), get("fl_y")
        cx, cy = get("cx"), get("cy")
        w, h = int(get("w", 2 * cx)), int(get("h", 2 * cy))
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        c2w_gl = np.asarray(fr["transform_matrix"], np.float32)
        cam = Camera.from_opengl(K, c2w_gl, w, h, device=device)
        if downscale > 1:
            cam = cam.resized(w // downscale, h // downscale)
        img_path = fr.get("file_path")
        if img_path is not None:
            img_path = os.path.join(root, img_path)
            if not os.path.splitext(img_path)[1]:
                img_path += ".png"
        depth_path = fr.get("depth_file_path")
        if depth_path is not None:
            depth_path = os.path.join(root, depth_path)
        # lens distortion (k1..k4/p1/p2 + camera_model, per-frame keys
        # override the top level, like intrinsics): Frame.load applies
        # the backward warp so downstream sees true pinhole images
        dist = distortion_from_meta(
            {k: get(k) for k in ("camera_model", "k1", "k2", "k3", "k4",
                                 "p1", "p2") if get(k) is not None})
        frames.append(Frame(camera=cam, image_path=img_path,
                            depth_path=depth_path, distortion=dist))
    return frames


def parse_dataparser_transforms(path: str) -> Tuple[np.ndarray, float]:
    """Returns (transform (3,4), scale): normalized = scale * (T @ world)."""
    with open(path) as f:
        meta = json.load(f)
    return np.asarray(meta["transform"], np.float32)[:3, :4], float(meta["scale"])


def denormalize_points(points: np.ndarray, transform: np.ndarray,
                       scale: float) -> np.ndarray:
    """Map Nerfstudio-normalized points back to metric world coordinates
    (the inverse of the dataparser transform)."""
    p = points / scale
    R, t = transform[:, :3], transform[:, 3]
    return (p - t) @ R  # R orthonormal: inverse = transpose applied on the right


def camera_extent(frames: List[Frame]) -> float:
    """Scene extent from the camera rig, as splatfacto/3DGS derive it:
    1.1 x the radius of the camera bounding sphere (centered at the mean
    camera origin). Scales means-lr, the percent_dense split boundary and
    prune_scale3d_max to metric scenes."""
    centers = np.stack([f.camera.origin.cpu().numpy() for f in frames])
    center = centers.mean(axis=0)
    radius = float(np.linalg.norm(centers - center, axis=1).max())
    return 1.1 * radius if radius > 0 else 1.0


def train_eval_split(frames: List[Frame], eval_every: int = 8):
    train = [f for i, f in enumerate(frames) if i % eval_every != 0]
    eval_ = [f for i, f in enumerate(frames) if i % eval_every == 0]
    return train, eval_


# -- synthetic scenes (tests / benchmarks) --------------------------------


def synthetic_mesh_scene(seed: int, n_cameras: int, width: int, height: int,
                         camera_distance: float = 3.0,
                         with_depth: bool = False, device="cuda"):
    """A structured reconstruction target: a colorful multi-box scene
    rendered with the mesh rasterizer on `device` from a camera ring
    (coherent surfaces, unlike synthetic_scene's random splats). The
    boxes come from numpy's default_rng(seed), as in the JAX package, so
    a seed gives both packages the same mesh. Returns (mesh, frames with
    images, and with_depth the z-buffer, 0 on background pixels)."""
    from robosimgs_tpu_torch.render.mesh_raster import (MeshRasterConfig,
                                                        rasterize_mesh)
    from robosimgs_tpu_torch.utils.meshio import Mesh, concatenate

    rng = np.random.default_rng(seed)

    def box(center, size, color):
        sx, sy, sz = size
        v = np.array([[x, y, z] for x in (-sx, sx) for y in (-sy, sy)
                      for z in (-sz, sz)], np.float32) + np.asarray(center, np.float32)
        f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                      [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                      [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
        c = np.tile(np.asarray(color, np.float32), (8, 1))
        # vertex-color gradient for texture-like variation
        c = c * (0.6 + 0.4 * rng.uniform(size=(8, 1)).astype(np.float32))
        return Mesh(v, f, c)

    parts = [box((0, 0, -0.55), (1.2, 1.2, 0.05), (0.8, 0.75, 0.7))]  # floor
    for _ in range(6):
        center = rng.uniform(-0.7, 0.7, 3) * np.array([1, 1, 0.3])
        size = rng.uniform(0.08, 0.3, 3)
        color = rng.uniform(0.2, 0.95, 3)
        parts.append(box(center, size, color))
    scene = concatenate(parts)

    frames = []
    mcfg = MeshRasterConfig(tile_capacity=512)
    verts = torch.from_numpy(scene.vertices).to(device)
    faces = torch.from_numpy(scene.faces).to(device)
    colors = torch.from_numpy(scene.baked_vertex_colors()).to(device)
    for i in range(n_cameras):
        ang = 2 * np.pi * i / n_cameras
        eye = [camera_distance * np.cos(ang), camera_distance * np.sin(ang),
               1.2 + 0.3 * np.sin(2 * ang)]
        cam = Camera.look_at(eye, [0, 0, -0.1], [0, 0, 1], 50.0, width, height,
                             device=device)
        with torch.no_grad():
            out = rasterize_mesh(verts, faces, cam, vertex_colors=colors,
                                 cfg=mcfg)
        mask = out["mask"].cpu().numpy()
        img = np.where(mask[..., None], out["rgb"].cpu().numpy(),
                       1.0).astype(np.float32)
        dep = None
        if with_depth:
            # GT supervision target: mesh z-buffer where covered, 0
            # (= invalid) on background pixels
            dep = np.where(mask, out["depth"].cpu().numpy(),
                           0.0).astype(np.float32)
        frames.append(Frame(camera=cam, image=img, depth=dep))
    return scene, frames


def synthetic_scene(
    seed: int,
    n_gaussians: int,
    n_cameras: int,
    width: int,
    height: int,
    extent: float = 1.0,
    sh_degree: int = 2,
    camera_distance: float = 4.0,
    device="cuda",
) -> Tuple[Gaussians, List[Frame]]:
    """A random GT Gaussian scene + ring of cameras (targets are rendered
    by the caller, so the same scene serves any config). The scene is
    drawn from a CPU `torch.Generator` seeded with `seed`: the same seed
    gives the same scene on any device, and not the JAX package's."""
    gt = Gaussians.random(torch.Generator().manual_seed(seed), n_gaussians,
                          sh_degree=sh_degree, extent=extent, device=device)
    frames = []
    for i in range(n_cameras):
        ang = 2 * np.pi * i / n_cameras
        eye = [camera_distance * np.cos(ang), camera_distance * np.sin(ang),
               1.0 + 0.5 * np.sin(3 * ang)]
        cam = Camera.look_at(eye, [0, 0, 0], [0, 0, 1], 60.0, width, height,
                             device=device)
        frames.append(Frame(camera=cam))
    return gt, frames
