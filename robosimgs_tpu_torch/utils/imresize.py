"""Image resampling and 8-bit PNG input, without Pillow.

`resize_linear` and `resize_nearest` are `jax.image.resize`'s "linear"
(a triangle filter that widens by the reduction factor when it shrinks,
so it antialiases) and "nearest" (source index floor((i + 0.5) in / out)
in float32), on torch tensors and numpy arrays.

`resize_bicubic` is Pillow's `Image.resize(size)` (BICUBIC, its default
for RGB) on 8-bit images, in numpy: a separable filter with a = -0.5
whose support widens by the reduction factor, weights normalized per
output pixel and quantized to 22-bit fixed point, a horizontal pass and
then a vertical one, each rounded and clipped to uint8 (a pass is
skipped when its axis keeps its size). `read_png_rgb` reads
non-interlaced 8-bit PNGs of every colour type and row filter (what
cli/render.py's `write_png` and Pillow write) as Pillow's
`convert("RGB")` does, and `read_png_array` as np.asarray(Image.open)
does (alpha kept), in numpy and zlib alone, so that they run where
Pillow is not installed.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np
import torch

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


# channels a pixel carries at bit depth 8, by PNG colour type: grey,
# RGB, palette index, grey + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters of (h, 1 + stride) uint8 scanlines
    (each led by its filter type) into (h, stride) uint8 bytes. A row
    depends on the row before it; None, Up and Sub (a running sum, mod
    256 in uint8) are vectorised within the row, Average and Paeth read
    the byte bpp to the left as they write it, so they run byte by byte."""
    h, stride = raw.shape[0], raw.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(raw[y, 0]), raw[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            cur = line + prior
        elif ftype in (3, 4):
            f, b = line.tolist(), prior.tolist()
            c = [0] * stride
            for i in range(stride):
                left = c[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    c[i] = (f[i] + ((left + b[i]) >> 1)) & 0xFF
                    continue
                up_left = b[i - bpp] if i >= bpp else 0
                p = left + b[i] - up_left
                pa, pb, pc = abs(p - left), abs(p - b[i]), abs(p - up_left)
                pred = (left if pa <= pb and pa <= pc
                        else b[i] if pb <= pc else up_left)
                c[i] = (f[i] + pred) & 0xFF
            cur = np.asarray(c, np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {ftype} in row {y}")
        out[y] = prior = cur
    return out


def _decode_png(path: str):
    """(px (H, W, channels) uint8, colour type, palette (n, 3) uint8 or
    None) of a non-interlaced 8-bit PNG, its rows unfiltered; palette
    PNGs give their indices. Raises ValueError on any other PNG (16-bit,
    bit depth below 8, interlaced)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header, palette = 8, [], None, None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace != 0 or color not in _CHANNELS:
        raise ValueError(f"{path}: only non-interlaced 8-bit PNGs are read "
                         f"(bit depth {depth}, color type {color}, interlace "
                         f"{interlace})")
    ch = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw[:h * (1 + w * ch)].reshape(h, 1 + w * ch),
                   ch).reshape(h, w, ch)
    return px, color, palette


def read_png_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a non-interlaced 8-bit PNG of any colour
    type (grey, RGB, palette, grey + alpha, RGBA) and any row filters,
    as Pillow's Image.open(path).convert("RGB") gives them: grey is
    replicated, alpha dropped, palette entries looked up. Raises
    ValueError on any other PNG (16-bit, bit depth below 8, interlaced)."""
    px, color, palette = _decode_png(path)
    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without a PLTE chunk")
        # entries past the palette read as black
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[px[..., 0]]
    if px.shape[2] <= 2:                          # grey, grey + alpha
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])      # RGB, RGBA


def read_png_array(path: str) -> np.ndarray:
    """The uint8 array np.asarray(Image.open(path)) gives for the same
    PNG, alpha kept: (H, W) for grey and for palette PNGs (the palette
    indices, not their colours), (H, W, 2) grey + alpha, (H, W, 3) RGB,
    (H, W, 4) RGBA. The same PNGs as `read_png_rgb`; raises ValueError
    on any other."""
    px, _, _ = _decode_png(path)
    return px[..., 0] if px.shape[2] == 1 else px


def _triangle_weights(in_size: int, out_size: int) -> np.ndarray:
    """jax.image's (in, out) float32 weight matrix of the antialiased
    triangle filter (compute_weight_mat): output i samples the input at
    (i + 0.5) in / out - 0.5, the kernel widened by
    max(in / out, 1), each column normalised to sum 1."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    # XLA fuses (i + 0.5) * inv_scale - 0.5 into one FMA: one rounding
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
              .astype(np.float64) * np.float64(inv_scale) - 0.5
              ).astype(np.float32)
    x = (np.abs(sample[None, :]
                - np.arange(in_size, dtype=np.float32)[:, None])
         / kernel_scale)
    w = np.maximum(np.float32(0), np.float32(1) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, np.float32(0))


def resize_linear(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """jax.image.resize(img, (height, width, C), "linear") of an (H, W, C)
    float32 tensor, on its device: one f32 contraction per axis with the
    triangle weights (an axis that keeps its size is left as it is)."""
    out = img
    if height != img.shape[0]:
        wh = torch.from_numpy(_triangle_weights(img.shape[0], height))
        out = torch.einsum("hwc,ho->owc", out, wh.to(img.device))
    if width != img.shape[1]:
        ww = torch.from_numpy(_triangle_weights(img.shape[1], width))
        out = torch.einsum("hwc,wo->hoc", out, ww.to(img.device))
    return out


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    return np.floor((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                    * np.float32(in_size) / np.float32(out_size)
                    ).astype(np.int64)


def resize_nearest(x, height: int, width: int):
    """jax.image.resize(x, (height, width), "nearest") of an (H, W, ...)
    numpy array or tensor."""
    rows = _nearest_index(x.shape[0], height)
    cols = _nearest_index(x.shape[1], width)
    if isinstance(x, torch.Tensor):
        rows, cols = (torch.from_numpy(rows).to(x.device),
                      torch.from_numpy(cols).to(x.device))
    return x[rows][:, cols]
