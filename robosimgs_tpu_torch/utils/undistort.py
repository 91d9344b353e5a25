"""Lens undistortion for COLMAP captures (host-side, numpy).

A copy of robosimgs_tpu/utils/undistort.py (the port imports nothing
from the JAX package; this module never needed JAX).

Captures processed upstream (``ns-process-data`` runs COLMAP's
``image_undistorter`` before splatfacto) arrive undistorted; raw COLMAP
output does not, and then the lens model has to be undone here or the
pinhole projection in `render/project.py` is wrong near the image
borders. This module applies it.

Models: the OpenCV radial-tangential RATIONAL polynomial and the
OpenCV FISHEYE (equidistant) model — the superset of every camera
model `utils/colmap.py` accepts::

    SIMPLE_RADIAL (k1)          RADIAL (k1, k2)
    OPENCV (k1, k2, p1, p2)     FULL_OPENCV (k1..k6, p1, p2 rational)
    OPENCV_FISHEYE (k1..k4)     SIMPLE_RADIAL_FISHEYE / RADIAL_FISHEYE

all normalized here to a canonical 9-vector
``(k1, k2, p1, p2, k3, k4, k5, k6, fisheye_flag)`` — the phone-capture
COLMAP models. A plain ndarray (not a class) so
`Frame.distortion` round-trips through numpy and the
``any(|d| > eps)`` "is there distortion at all" guards keep working:
the fisheye FLAG itself forces the warp, because a fisheye camera with
all-zero coefficients is still the equidistant projection, not a
pinhole. Length-4 vectors ``(k1, k2, p1, p2)`` are accepted everywhere
for backward compatibility.

Direction of the warp: the polynomial maps *ideal* (pinhole) normalized
coordinates to *distorted* ones. Producing an undistorted image is
therefore a backward warp — for every output pixel, distort its
normalized coordinates and bilinearly sample the captured image there.
No iterative inversion is needed on the image path; `undistort_points`
(fixed-point inversion) exists for mapping captured 2D features
(e.g. COLMAP keypoints) into the pinhole frame.

This runs once per image on the host at dataset-load time (it is not a
training-step op), so it is plain vectorized numpy, kept off the device.

Pixel convention matches `core/camera.py`: the center of pixel
(row i, col j) is (x=j, y=i) and u = fx*x + cx - 0.5, hence
x = (u + 0.5 - cx) / fx.
"""

from __future__ import annotations

import numpy as np


def _expand(dist) -> np.ndarray:
    """Any accepted distortion vector -> canonical 9-vector
    (k1, k2, p1, p2, k3, k4, k5, k6, fisheye_flag)."""
    v = np.asarray(dist, np.float64).ravel()
    if v.shape[0] == 9:
        return v
    if v.shape[0] == 4:
        return np.concatenate([v, np.zeros(5)])
    raise ValueError(f"distortion vector must be length 4 or 9, got {v.shape}")


def is_fisheye(dist) -> bool:
    return bool(_expand(dist)[8] != 0.0)


def normalize_distortion(model: str, params) -> np.ndarray:
    """COLMAP per-model distortion params -> the canonical 9-vector."""
    p = np.zeros(9, np.float64)
    vals = np.asarray(params, np.float64).ravel()
    if model in ("SIMPLE_PINHOLE", "PINHOLE"):
        pass
    elif model == "SIMPLE_RADIAL":
        p[0] = vals[0]
    elif model == "RADIAL":
        p[:2] = vals[:2]
    elif model == "OPENCV":
        p[: len(vals)] = vals[:4]
    elif model == "FULL_OPENCV":
        # COLMAP order: k1, k2, p1, p2, k3, k4, k5, k6 (rational model)
        p[: len(vals)] = vals[:8]
    elif model == "OPENCV_FISHEYE":
        # COLMAP order: k1, k2, k3, k4 (theta-polynomial)
        p[0], p[1] = vals[0], vals[1]
        if len(vals) > 2:
            p[4] = vals[2]
        if len(vals) > 3:
            p[5] = vals[3]
        p[8] = 1.0
    elif model == "SIMPLE_RADIAL_FISHEYE":
        p[0] = vals[0]
        p[8] = 1.0
    elif model == "RADIAL_FISHEYE":
        p[:2] = vals[:2]
        p[8] = 1.0
    else:
        raise ValueError(f"unsupported distortion model {model}")
    return p


def distortion_from_meta(meta: dict) -> np.ndarray:
    """Nerfstudio transforms.json distortion keys -> canonical 9-vector.

    Reads k1..k4, p1, p2 and camera_model ("OPENCV" default /
    "OPENCV_FISHEYE"); returns None when every coefficient is absent or
    zero AND the model is not fisheye."""
    model = str(meta.get("camera_model", "OPENCV"))
    ks = [float(meta.get(k, 0.0) or 0.0)
          for k in ("k1", "k2", "k3", "k4")]
    ps = [float(meta.get(k, 0.0) or 0.0) for k in ("p1", "p2")]
    fisheye = "FISHEYE" in model.upper()
    if not fisheye and not any(abs(v) > 1e-12 for v in ks + ps):
        return None
    p = np.zeros(9, np.float64)
    p[0], p[1] = ks[0], ks[1]
    p[4], p[5] = ks[2], ks[3]
    if fisheye:
        p[8] = 1.0
    else:
        p[2], p[3] = ps[0], ps[1]
    return p


def _fisheye_theta_d(theta: np.ndarray, k: np.ndarray) -> np.ndarray:
    t2 = theta * theta
    return theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))


def distort_normalized(xy: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """Ideal normalized coords (..., 2) -> distorted normalized coords."""
    d = _expand(dist)
    x, y = np.asarray(xy[..., 0], np.float64), np.asarray(xy[..., 1], np.float64)
    if d[8] != 0.0:
        # OpenCV fisheye (equidistant): r -> theta_d(atan(r)) / r
        r = np.sqrt(x * x + y * y)
        theta = np.arctan(r)
        theta_d = _fisheye_theta_d(theta, d[[0, 1, 4, 5]])
        scale = np.where(r > 1e-12, theta_d / np.maximum(r, 1e-12), 1.0)
        return np.stack([x * scale, y * scale], axis=-1)
    k1, k2, p1, p2, k3, k4, k5, k6 = d[:8]
    r2 = x * x + y * y
    radial = ((1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
              / (1.0 + r2 * (k4 + r2 * (k5 + r2 * k6))))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return np.stack([xd, yd], axis=-1)


def undistort_points(xy_dist: np.ndarray, dist: np.ndarray,
                     iters: int = 10) -> np.ndarray:
    """Invert `distort_normalized` by fixed-point iteration.

    Radtan: x <- (xd - tangential(x)) / radial(x), starting from x = xd
    (the scheme OpenCV's undistortPoints uses). Fisheye: Newton on the
    odd theta-polynomial theta_d(theta) = r_d, then r = tan(theta).
    Convergent for the moderate coefficients real captures have.
    """
    d = _expand(dist)
    xd, yd = (np.asarray(xy_dist[..., 0], np.float64),
              np.asarray(xy_dist[..., 1], np.float64))
    if d[8] != 0.0:
        k = d[[0, 1, 4, 5]]
        rd = np.sqrt(xd * xd + yd * yd)
        theta = rd.copy()
        for _ in range(iters):
            t2 = theta * theta
            f = _fisheye_theta_d(theta, k) - rd
            df = 1.0 + t2 * (3 * k[0] + t2 * (5 * k[1] + t2 * (7 * k[2]
                                                               + t2 * 9 * k[3])))
            theta = theta - f / np.maximum(df, 1e-9)
        r = np.tan(theta)
        scale = np.where(rd > 1e-12, r / np.maximum(rd, 1e-12), 1.0)
        return np.stack([xd * scale, yd * scale], axis=-1)
    k1, k2, p1, p2, k3, k4, k5, k6 = d[:8]
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        radial = ((1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
                  / (1.0 + r2 * (k4 + r2 * (k5 + r2 * k6))))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return np.stack([x, y], axis=-1)


def _bilinear(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Sample img (H, W, C) at continuous (u=x, v=y), edge-clamped."""
    h, w = img.shape[:2]
    u = np.clip(u, 0.0, w - 1.0)
    v = np.clip(v, 0.0, h - 1.0)
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    u1 = np.minimum(u0 + 1, w - 1)
    v1 = np.minimum(v0 + 1, h - 1)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    top = img[v0, u0] * (1 - fu) + img[v0, u1] * fu
    bot = img[v1, u0] * (1 - fu) + img[v1, u1] * fu
    return top * (1 - fv) + bot * fv


def undistort_image(img: np.ndarray, fx: float, fy: float,
                    cx: float, cy: float, dist: np.ndarray) -> np.ndarray:
    """Backward-warp a captured image onto the ideal pinhole grid.

    Keeps the original intrinsics (no optimal-new-K recentering, like
    COLMAP's image_undistorter with blank_pixels=0): output pixels whose
    source falls outside the capture are edge-clamped. Returns float32
    (H, W, C).
    """
    dist = np.asarray(dist, np.float64)
    if not np.any(np.abs(dist) > 1e-12):
        return np.asarray(img, np.float32)
    h, w = img.shape[:2]
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    xy = np.stack([(u + 0.5 - cx) / fx, (v + 0.5 - cy) / fy], axis=-1)
    xyd = distort_normalized(xy, dist)
    ud = xyd[..., 0] * fx + cx - 0.5
    vd = xyd[..., 1] * fy + cy - 0.5
    return _bilinear(np.asarray(img, np.float32), ud, vd).astype(np.float32)
