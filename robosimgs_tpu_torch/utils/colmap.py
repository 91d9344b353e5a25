"""COLMAP sparse-reconstruction reader (binary format).

A copy of robosimgs_tpu/utils/colmap.py with its imports re-pointed to
the port; cameras are built on the `device` load_colmap is given.

The capture front-end of the 3DGS training path: Nerfstudio's
transforms.json (train/data.py) is one interface; raw COLMAP output
(`sparse/0/{cameras,images,points3D}.bin`) is the other standard one.
Provides cameras/poses as Frames and the SfM point cloud that seeds
Gaussian initialization (Nerfstudio's COLMAP processing provides both
upstream of splatfacto).

Supported camera models: SIMPLE_PINHOLE, PINHOLE, SIMPLE_RADIAL,
RADIAL, OPENCV. Distortion coefficients are carried on each Frame and
removed at image-load time (`utils/undistort.py`), matching what
ns-process-data's COLMAP image_undistorter does upstream of the
reference pipeline.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.train.data import Frame
from robosimgs_tpu_torch.utils.undistort import normalize_distortion

_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),   # f, cx, cy
    1: ("PINHOLE", 4),          # fx, fy, cx, cy
    2: ("SIMPLE_RADIAL", 4),    # f, cx, cy, k
    3: ("RADIAL", 5),           # f, cx, cy, k1, k2
    4: ("OPENCV", 8),           # fx, fy, cx, cy, k1, k2, p1, p2
}


def _read(fh, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, fh.read(size))


def read_cameras_bin(path: str) -> Dict[int, Dict]:
    cameras = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(fh, "<iiQQ")
            name, n_params = _CAMERA_MODELS.get(model_id, (None, None))
            if name is None:
                raise ValueError(f"unsupported COLMAP camera model {model_id}")
            params = np.asarray(_read(fh, f"<{n_params}d"))
            if name in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
                fx = fy = params[0]
                cx, cy = params[1], params[2]
                dist = params[3:]
            else:
                fx, fy, cx, cy = params[:4]
                dist = params[4:]
            cameras[cam_id] = {
                "model": name, "width": int(width), "height": int(height),
                "fx": fx, "fy": fy, "cx": cx, "cy": cy,
                "distortion": dist.tolist(),
            }
    return cameras


def read_images_bin(path: str) -> List[Dict]:
    images = []
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            image_id, qw, qx, qy, qz, tx, ty, tz, cam_id = _read(fh, "<idddddddi")
            name = b""
            while True:
                c = fh.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(fh, "<Q")
            fh.read(24 * n_pts)   # 2D points + point3D ids: skipped
            images.append({
                "image_id": image_id, "camera_id": cam_id,
                "name": name.decode("utf-8"),
                "qvec": np.asarray([qw, qx, qy, qz]),
                "tvec": np.asarray([tx, ty, tz]),
            })
    return images


def read_points3d_bin(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (xyz (N,3) float32, rgb (N,3) float32 in [0,1])."""
    xyz, rgb = [], []
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            _, x, y, z, r, g, b, _err = _read(fh, "<QdddBBBd")
            (track_len,) = _read(fh, "<Q")
            fh.read(8 * track_len)
            xyz.append((x, y, z))
            rgb.append((r, g, b))
    return (np.asarray(xyz, np.float32),
            np.asarray(rgb, np.float32) / 255.0)


def _qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def load_colmap(sparse_dir: str, images_dir: Optional[str] = None,
                downscale: int = 1, device="cuda"
                ) -> Tuple[List[Frame], np.ndarray, np.ndarray]:
    """Load a COLMAP sparse model.

    Returns (frames, points_xyz, points_rgb). COLMAP stores world->cam
    (R = qvec, t = tvec) in OpenCV convention — inverted here to c2w.
    """
    cameras = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
    images = read_images_bin(os.path.join(sparse_dir, "images.bin"))
    pts_path = os.path.join(sparse_dir, "points3D.bin")
    if os.path.exists(pts_path):
        xyz, rgb = read_points3d_bin(pts_path)
    else:
        xyz = np.zeros((0, 3), np.float32)
        rgb = np.zeros((0, 3), np.float32)

    frames = []
    for im in sorted(images, key=lambda d: d["name"]):
        c = cameras[im["camera_id"]]
        # lens model -> canonical (k1, k2, p1, p2); Frame.load applies
        # the backward warp so downstream sees true pinhole images
        dist = normalize_distortion(c["model"], c["distortion"])
        R = _qvec_to_rotmat(im["qvec"])
        t = im["tvec"]
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = R.T
        c2w[:3, 3] = -R.T @ t
        K = np.array([[c["fx"], 0, c["cx"]], [0, c["fy"], c["cy"]],
                      [0, 0, 1]], np.float32)
        cam = Camera.from_opencv(K, c2w, c["width"], c["height"],
                                 device=device)
        if downscale > 1:
            cam = cam.resized(c["width"] // downscale, c["height"] // downscale)
        img_path = (os.path.join(images_dir, im["name"])
                    if images_dir else None)
        frames.append(Frame(camera=cam, image_path=img_path,
                            distortion=dist))
    return frames, xyz, rgb
