"""Extended Nerfstudio interop: depth files, RGBA loading, scene splits.

A port of robosimgs_tpu/utils/nerfstudio.py, numpy on the host as there:

  load_image_with_background — RGBA -> RGB with background fill
  load_depth_npy_gz          — Nerfstudio .npy.gz depth maps
  depth_to_distance / distance_to_depth — per-pixel ray-length <-> z
  unproject_pixel            — single-pixel unprojection to world
  scene_splits               — train/eval fraction splits
  load_points_denormalized   — an exported point cloud back in metric
                               world coordinates

The functions that take a Camera read its intrinsics and pose on the
CPU, whatever device the camera lives on.
"""

from __future__ import annotations

import gzip
import io
import os
from typing import List, Sequence, Tuple

import numpy as np

from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.train.data import (denormalize_points,
                                            parse_dataparser_transforms)
from robosimgs_tpu_torch.utils.imresize import PNG_SIGNATURE, read_png_array
from robosimgs_tpu_torch.utils.meshio import _load_ply_mesh


def _image_array(path: str) -> np.ndarray:
    """np.asarray(Image.open(path)): PNGs by the port's own reader,
    other formats through Pillow, which must then be installed."""
    with open(path, "rb") as fh:
        is_png = fh.read(len(PNG_SIGNATURE)) == PNG_SIGNATURE
    if is_png:
        return read_png_array(path)
    try:
        from PIL import Image
    except ImportError as e:
        fmt = os.path.splitext(path)[1] or "extensionless"
        raise ImportError(
            f"{path}: not a PNG; reading a {fmt} image needs Pillow, which "
            f"is not installed (the port reads 8-bit PNGs without it)") from e
    return np.asarray(Image.open(path))


def load_image_with_background(path: str,
                               background: Sequence[float] = (1.0, 1.0, 1.0)
                               ) -> np.ndarray:
    """Load an image; alpha-composite RGBA over a background color.
    Returns (H, W, 3) float32 in [0, 1].

    As the JAX function: a grey image is replicated to 3 channels, a
    palette image gives its indices / 255 (not its colours), and a
    grey + alpha image comes back (H, W, 2), grey and alpha, with no
    compositing."""
    arr = _image_array(path).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    if arr.shape[-1] == 4:
        a = arr[..., 3:4]
        arr = arr[..., :3] * a + np.asarray(background, np.float32) * (1 - a)
    return arr[..., :3]


def load_depth_npy_gz(path: str) -> np.ndarray:
    """Load a gzip-compressed .npy depth map (Nerfstudio export format)."""
    with gzip.open(path, "rb") as fh:
        return np.load(io.BytesIO(fh.read()))


def _ray_lengths(camera: Camera, H: int, W: int) -> np.ndarray:
    """Per-pixel |ray| for unit z (distance = depth * |ray|)."""
    xs = (np.arange(W) + 0.5 - float(camera.cx)) / float(camera.fx)
    ys = (np.arange(H) + 0.5 - float(camera.cy)) / float(camera.fy)
    xv, yv = np.meshgrid(xs, ys)
    return np.sqrt(xv**2 + yv**2 + 1.0)


def depth_to_distance(depth: np.ndarray, camera: Camera) -> np.ndarray:
    """Planar z-depth -> euclidean ray distance."""
    H, W = depth.shape
    return depth * _ray_lengths(camera, H, W)


def distance_to_depth(distance: np.ndarray, camera: Camera) -> np.ndarray:
    """Euclidean ray distance -> planar z-depth."""
    H, W = distance.shape
    return distance / _ray_lengths(camera, H, W)


def unproject_pixel(u: float, v: float, depth: float,
                    camera: Camera) -> np.ndarray:
    """One pixel + planar depth -> world point (numpy)."""
    x = (u + 0.5 - float(camera.cx)) / float(camera.fx) * depth
    y = (v + 0.5 - float(camera.cy)) / float(camera.fy) * depth
    cam_pt = np.array([x, y, depth, 1.0], np.float32)
    return (camera.c2w.detach().cpu().numpy() @ cam_pt)[:3]


def scene_splits(n: int, eval_fraction: float = 0.1,
                 seed: int = 0) -> Tuple[List[int], List[int]]:
    """Random train/eval index split (reference scene-splits role)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    n_eval = max(1, int(round(n * eval_fraction)))
    return sorted(idx[n_eval:].tolist()), sorted(idx[:n_eval].tolist())


def load_points_denormalized(ply_path: str, dataparser_transforms_path: str,
                             voxel_size: float = 0.0) -> np.ndarray:
    """Load a Nerfstudio-exported point cloud and map it back to metric
    world coordinates; voxel_size > 0 keeps the first point of each
    voxel, in file order."""
    pts = _load_ply_mesh(ply_path).vertices
    if voxel_size > 0:
        keys = np.floor(pts / voxel_size).astype(np.int64)
        _, idx = np.unique(keys, axis=0, return_index=True)
        pts = pts[np.sort(idx)]
    T, scale = parse_dataparser_transforms(dataparser_transforms_path)
    return denormalize_points(pts, T, scale)
