"""numpy stand-ins for the five OpenCV calls of the segmentation stage.

The JAX package's artic/segmentation.py calls cv2.dilate and cv2.erode
(a px x px ones kernel), cv2.distanceTransform(DIST_L2, 3), cv2.Sobel
(CV_32F, ksize 3) and cv2.putText. OpenCV is not a dependency of the
port, so each has a counterpart here, on host numpy arrays:

- `dilate`, `erode`: OpenCV's rectangular morphology with its default
  anchor (px // 2, px // 2), so an even px reaches offsets -px/2 .. px/2 - 1;
  the outside of the image never wins (0 for dilation, 1 for erosion).
- `distance_transform_l2_3`: OpenCV's two-pass 3x3 chamfer distance in
  float32 (steps 0.955 and 1.3693, not the Euclidean distance), the same
  additions in the same dependency order, so bit-equal; FLT_MAX where no
  zero pixel exists, and the border is not a zero pixel.
- `sobel3`: the 3x3 Sobel derivative with BORDER_REFLECT_101, as a row
  pass and a column pass in float32.
- `stamp_label`: a "#N" label from a 5x7 bitmap font of the port's own,
  drawn inside the box cv2.getTextSize gives for cv2.FONT_HERSHEY_SIMPLEX
  at that scale (the pixels inside differ from OpenCV's glyphs).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

# OpenCV's DIST_L2 mask-3 steps (distransform.cpp: horizontal/vertical,
# diagonal)
_HV = np.float32(0.955)
_DIAG = np.float32(1.3693)
_FLT_MAX = np.float32(np.finfo(np.float32).max)


def _rect_reduce(mask: np.ndarray, px: int, op, fill: bool) -> np.ndarray:
    """op over the px x px window at offsets -(px // 2) .. px - 1 - px // 2
    of each pixel, the outside of the image reading `fill`; separable."""
    out = np.asarray(mask, bool)
    a = px // 2
    for axis in (0, 1):
        n = out.shape[axis]
        pad = [(0, 0), (0, 0)]
        pad[axis] = (a, px - 1 - a)
        padded = np.pad(out, pad, constant_values=fill)
        acc = np.take(padded, np.arange(n), axis=axis)
        for k in range(1, px):
            acc = op(acc, np.take(padded, np.arange(k, k + n), axis=axis))
        out = acc
    return out


def dilate(mask: np.ndarray, px: int) -> np.ndarray:
    """cv2.dilate(mask, np.ones((px, px))) > 0 of a (H, W) mask, as bool."""
    return _rect_reduce(mask, px, np.logical_or, False)


def erode(mask: np.ndarray, px: int) -> np.ndarray:
    """cv2.erode(mask, np.ones((px, px))) > 0 of a (H, W) mask, as bool."""
    return _rect_reduce(mask, px, np.logical_and, True)


def _chamfer_pass(t: np.ndarray) -> None:
    """OpenCV's forward 3x3 pass over t, a (H + 2, W + 2) float32 array
    whose one-pixel frame reads FLT_MAX: in scan order, each inner pixel
    becomes min(itself, up-left + b, up + a, up-right + b, left + a).
    Pixel (i, j) depends on pixels of smaller 2 i + j only, so the pass
    runs over the wavefronts 2 i + j = s, each a strided slice of the flat
    array (step W), with the same float32 additions as the scan."""
    h, w = t.shape[0] - 2, t.shape[1] - 2
    row = w + 2
    flat = t.reshape(-1)
    for s in range(2 * (h - 1) + w):
        i0 = max(0, (s - w + 2) // 2)
        i1 = min(h - 1, s // 2)
        # flat index of inner (i, s - 2 i): (i + 1) row + s - 2 i + 1
        f0 = row + s + 1 + i0 * w
        sl = slice(f0, f0 + (i1 - i0) * w + 1, w)
        up = slice(f0 - row, f0 - row + (i1 - i0) * w + 1, w)
        cur = flat[sl]
        cand = np.minimum(flat[up.start - 1:up.stop - 1:w] + _DIAG,
                          flat[up] + _HV)
        cand = np.minimum(cand, flat[up.start + 1:up.stop + 1:w] + _DIAG)
        cand = np.minimum(cand, flat[sl.start - 1:sl.stop - 1:w] + _HV)
        flat[sl] = np.minimum(cur, cand)


def distance_transform_l2_3(mask: np.ndarray) -> np.ndarray:
    """cv2.distanceTransform(mask.astype(np.uint8), cv2.DIST_L2, 3): each
    nonzero pixel's chamfer distance to the nearest zero pixel, float32."""
    m = np.asarray(mask)
    h, w = m.shape
    t = np.full((h + 2, w + 2), _FLT_MAX, np.float32)
    t[1:-1, 1:-1] = np.where(m != 0, _FLT_MAX, np.float32(0))
    _chamfer_pass(t)
    back = np.ascontiguousarray(t[::-1, ::-1])
    _chamfer_pass(back)
    return np.ascontiguousarray(back[::-1, ::-1][1:-1, 1:-1])


def _reflect101(x: np.ndarray, axis: int) -> np.ndarray:
    n = x.shape[axis]
    idx = np.concatenate([[1 if n > 1 else 0], np.arange(n),
                          [n - 2 if n > 1 else 0]])
    return np.take(x, idx, axis=axis)


def _diff(x: np.ndarray, axis: int) -> np.ndarray:
    p = _reflect101(x, axis)
    n = x.shape[axis]
    return (np.take(p, np.arange(2, n + 2), axis=axis)
            - np.take(p, np.arange(n), axis=axis))


def _smooth(x: np.ndarray, axis: int) -> np.ndarray:
    p = _reflect101(x, axis)
    n = x.shape[axis]
    return ((np.take(p, np.arange(n), axis=axis)
             + np.take(p, np.arange(2, n + 2), axis=axis))
            + np.take(p, np.arange(1, n + 1), axis=axis) * np.float32(2))


def sobel3(gray: np.ndarray, dx: int, dy: int) -> np.ndarray:
    """cv2.Sobel(gray, cv2.CV_32F, dx, dy, ksize=3) for (dx, dy) = (1, 0)
    or (0, 1) of a (H, W) float32 image, BORDER_REFLECT_101: the row
    pass, then the column pass."""
    g = np.asarray(gray, np.float32)
    if (dx, dy) == (1, 0):
        return _smooth(_diff(g, 1), 0)
    if (dx, dy) == (0, 1):
        return _diff(_smooth(g, 1), 0)
    raise ValueError(f"sobel3 takes (dx, dy) = (1, 0) or (0, 1), got "
                     f"({dx}, {dy})")


# 5x7 bitmaps, one string of five columns a row, top row first
_GLYPHS = {
    "#": ["01010", "01010", "11111", "01010", "11111", "01010", "01010"],
    "0": ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    "1": ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    "2": ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    "3": ["11110", "00001", "00001", "01110", "00001", "00001", "11110"],
    "4": ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    "5": ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    "6": ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    "7": ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    "8": ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    "9": ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def stamp_label(img: np.ndarray, text: str, org: Tuple[int, int],
                scale: float, color: Sequence[int]) -> np.ndarray:
    """Draw `text` ('#' and digits) into the (H, W, 3) uint8 image in
    place, its baseline's left end at org = (x, y), as a bitmap font
    magnified k = max(1, int(2 scale)) times: k 5 x 7 k glyphs, one column
    of k pixels between them, on rows y - 7 k .. y - 1. That lies inside
    the box cv2.getTextSize gives for cv2.FONT_HERSHEY_SIMPLEX at `scale`
    (and thickness max(1, int(2 scale))) for the labels #1 .. #99."""
    k = max(1, int(2 * scale))
    x, y = org
    h, w = img.shape[:2]
    for n, ch in enumerate(text):
        bits = np.array([[c == "1" for c in r] for r in _GLYPHS[ch]])
        big = np.kron(bits, np.ones((k, k), bool))
        y0, x0 = y - 7 * k, x + n * 6 * k
        ys, xs = np.nonzero(big)
        ys, xs = ys + y0, xs + x0
        ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        img[ys[ok], xs[ok]] = np.asarray(color, img.dtype)
    return img
