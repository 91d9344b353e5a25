"""flax's msgpack state-dict format, read and written in pure Python.

`flax.serialization.to_bytes` packs a nested dict of arrays with msgpack,
each array as extension type 1: an inner msgpack array of (shape, dtype
name, C-order bytes). The port reads the mask model's weights in that
format without msgpack or flax: `loads` handles maps, strings, binary,
arrays, integers and floats, and extension 1; anything else raises,
naming the byte it found. `dumps` writes the encodings
msgpack-python chooses (the shortest), so a tree read from a file packs
back to the same bytes.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY = 1


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: {n} bytes wanted at offset "
                             f"{self.pos}, {len(self.data) - self.pos} left")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def value(self) -> Any:
        at = self.pos
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.take(b & 0x1f).decode("utf-8")
        if b in (0xc4, 0xc5, 0xc6):                       # bin 8/16/32
            return self.take(self.uint(1 << (b - 0xc4)))
        if b in (0xc7, 0xc8, 0xc9):                       # ext 8/16/32
            return self.ext(self.uint(1 << (b - 0xc7)), at)
        if b == 0xca:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xcb:
            return struct.unpack(">d", self.take(8))[0]
        if 0xcc <= b <= 0xcf:                             # uint 8..64
            return self.uint(1 << (b - 0xcc))
        if 0xd0 <= b <= 0xd3:                             # int 8..64
            n = 1 << (b - 0xd0)
            return int.from_bytes(self.take(n), "big", signed=True)
        if 0xd4 <= b <= 0xd8:                             # fixext 1..16
            return self.ext(1 << (b - 0xd4), at)
        if b in (0xd9, 0xda, 0xdb):                       # str 8/16/32
            return self.take(self.uint(1 << (b - 0xd9))).decode("utf-8")
        if b in (0xdc, 0xdd):                             # array 16/32
            return self.array(self.uint(2 if b == 0xdc else 4))
        if b in (0xde, 0xdf):                             # map 16/32
            return self.map(self.uint(2 if b == 0xde else 4))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x} at "
                         f"offset {at}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def ext(self, n: int, at: int) -> np.ndarray:
        code = struct.unpack("b", self.take(1))[0]
        if code != _EXT_NDARRAY:
            raise ValueError(f"msgpack: extension type {code} at offset {at}"
                             f" (only flax's ndarray, type 1, is read)")
        shape, dtype, buf = loads(self.take(n))
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def loads(data: bytes) -> Any:
    """One msgpack value from `data` (which it must fill exactly)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(data):
        raise ValueError(f"msgpack: {len(data) - r.pos} trailing bytes at "
                         f"offset {r.pos}")
    return out


def _len_header(n: int, fix: Tuple[int, int], sized: Tuple[int, ...],
                widths: Tuple[int, ...]) -> bytes:
    """A length prefix: the fix form (base byte, limit) when n fits, else
    the first sized form (type byte, byte width) that holds n."""
    base, limit = fix
    if n < limit:
        return bytes([base | n])
    for code, width in zip(sized, widths):
        if n < 1 << (8 * width):
            return bytes([code]) + n.to_bytes(width, "big")
    raise ValueError(f"msgpack: length {n} is too large")


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7f or -32 <= v < 0:
        return struct.pack("b", v) if v < 0 else bytes([v])
    if v >= 0:
        for code, fmt in ((0xcc, ">B"), (0xcd, ">H"), (0xce, ">I"),
                          (0xcf, ">Q")):
            if v < 1 << (8 * struct.calcsize(fmt)):
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt in ((0xd0, ">b"), (0xd1, ">h"), (0xd2, ">i"),
                          (0xd3, ">q")):
            if v >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"msgpack: integer {v} out of range")


def dumps(obj: Any) -> bytes:
    """msgpack bytes of a nested dict / list / tuple of str, bytes, int,
    float and numpy arrays (as flax's extension type 1)."""
    if isinstance(obj, (int, np.integer)):
        return _int(int(obj))
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        return _len_header(len(raw), (0xa0, 32), (0xd9, 0xda, 0xdb),
                           (1, 2, 4)) + raw
    if isinstance(obj, bytes):
        return _len_header(len(obj), (0xc4, 0), (0xc4, 0xc5, 0xc6),
                           (1, 2, 4)) + obj
    if isinstance(obj, (list, tuple)):
        return (_len_header(len(obj), (0x90, 16), (0xdc, 0xdd), (2, 4))
                + b"".join(dumps(v) for v in obj))
    if isinstance(obj, dict):
        return (_len_header(len(obj), (0x80, 16), (0xde, 0xdf), (2, 4))
                + b"".join(dumps(k) + dumps(v) for k, v in obj.items()))
    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        inner = dumps((tuple(int(s) for s in arr.shape), arr.dtype.name,
                       arr.tobytes("C")))
        n = len(inner)
        fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        if n in fixext:
            head = bytes([fixext[n]])
        else:
            head = _len_header(n, (0xc7, 0), (0xc7, 0xc8, 0xc9), (1, 2, 4))
        return head + struct.pack("b", _EXT_NDARRAY) + inner
    raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")
