"""8-bit image input for the policy stage, without Pillow.

`resize_bicubic` is Pillow's `Image.resize(size)` (BICUBIC, its default
for RGB) on 8-bit images, in numpy: a separable filter with a = -0.5
whose support widens by the reduction factor, weights normalized per
output pixel and quantized to 22-bit fixed point, a horizontal pass and
then a vertical one, each rounded and clipped to uint8 (a pass is
skipped when its axis keeps its size). `read_png_rgb` reads the 8-bit
RGB PNGs the port's writers write (cli/render.py's `write_png`).
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

_PRECISION_BITS = 32 - 8 - 2
_A = -0.5


def _bicubic(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    near = ((_A + 2.0) * x - (_A + 3.0)) * x * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * _A
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size: int, out_size: int):
    """Per output pixel: the first source index (out,), the fixed-point
    tap weights (out, ksize) (0 past the pixel's taps), as Pillow's
    precompute_coeffs and normalize_coeffs_8bpc compute them in double."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    taps = np.arange(ksize)[None, :]
    w = _bicubic((taps + xmin[:, None] - center[:, None] + 0.5)
                 / filterscale)
    w = np.where(taps < xmax[:, None], w, 0.0)
    total = np.cumsum(w, axis=1)[:, -1:]       # summed in order, as C does
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    one = float(1 << _PRECISION_BITS)
    k = np.where(w < 0, np.trunc(-0.5 + w * one), np.trunc(0.5 + w * one))
    return xmin, k.astype(np.int64)


def _resample(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One 8-bit pass of (H, W, C) uint8 along axis 0 or 1."""
    in_size = img.shape[axis]
    xmin, k = _coeffs(in_size, out_size)
    shape = [1, 1, 1]
    shape[axis] = out_size
    acc = np.full(tuple(s if i != axis else out_size
                        for i, s in enumerate(img.shape)),
                  1 << (_PRECISION_BITS - 1), np.int64)
    src = img.astype(np.int64)
    for j in range(k.shape[1]):
        idx = np.minimum(xmin + j, in_size - 1)
        acc += np.take(src, idx, axis=axis) * k[:, j].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W, C) uint8 -> (height, width, C) uint8, as Pillow's
    Image.resize((width, height)) (BICUBIC)."""
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize_bicubic takes (H, W, C) uint8, got "
                         f"{img.dtype} {img.shape}")
    out = img
    if width != img.shape[1]:
        out = _resample(out, 1, width)
    if height != img.shape[0]:
        out = _resample(out, 0, height)
    return out


def read_png_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 pixels of an 8-bit RGB, non-interlaced PNG whose
    rows are unfiltered (what cli/render.py's write_png writes); raises
    ValueError on any other PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB",
                                                                body)
            if (depth, color, interlace) != (8, 2, 0):
                raise ValueError(f"{path}: only 8-bit RGB non-interlaced "
                                 f"PNGs are read (depth {depth}, color type "
                                 f"{color}, interlace {interlace})")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise ValueError(f"{path}: filtered PNG rows are not read")
    return raw[:, 1:].reshape(h, w, 3)
