"""utils/imresize.py::read_png_rgb against Pillow's
`Image.open(p).convert("RGB")`, exactly, on files Pillow writes: noise and
a smooth ramp in every 8-bit colour type (grey, RGB, palette, grey +
alpha, RGBA) and at odd sizes, whose rows Pillow filters by None, Sub, Up
and Paeth; Pillow's encoder never picks Average, so each filter is also
applied to every row of a file written here and decoded by both; and the
PNGs it does not read (16-bit, interlaced, bit depth below 8) raise."""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from robosimgs_tpu_torch.utils.imresize import read_png_rgb

MODES = ["RGB", "L", "LA", "RGBA", "P"]
SIZES = [(23, 37), (48, 64), (1, 300)]


def _image(kind, h, w):
    if kind == "noise":
        return np.random.default_rng(h * w).integers(0, 256, (h, w, 3),
                                                     dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (3 * xx + 2 * yy) % 256], -1).astype(np.uint8)


def _save(path, arr, mode):
    im = Image.fromarray(arr)
    if mode == "P":
        im = im.convert("P", palette=Image.Palette.ADAPTIVE, colors=256)
    elif mode != "RGB":
        im = im.convert(mode)
    im.save(path)


def _filters(path):
    """The filter type of each row of an 8-bit non-interlaced PNG."""
    data = open(path, "rb").read()
    pos, idat, w, h, ch = 8, b"", 0, 0, 0
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, _, color = struct.unpack(">IIBB", body[:10])
            ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, 1 + w * ch)[:, 0].tolist())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["noise", "ramp"])
@pytest.mark.parametrize("size", SIZES, ids=["23x37", "48x64", "1x300"])
def test_read_png_rgb_equals_pillow(tmp_path, mode, kind, size):
    path = str(tmp_path / "a.png")
    _save(path, _image(kind, *size), mode)
    want = np.asarray(Image.open(path).convert("RGB"))
    got = read_png_rgb(path)
    assert got.dtype == np.uint8 and got.shape == want.shape == size + (3,)
    np.testing.assert_array_equal(got, want)


def test_pillow_writes_four_filters(tmp_path):
    """The Pillow-written cases above exercise None, Sub, Up and Paeth."""
    seen = set()
    for mode in MODES:
        for kind in ("noise", "ramp"):
            for size in SIZES:
                path = str(tmp_path / f"{mode}_{kind}_{size[0]}.png")
                _save(path, _image(kind, *size), mode)
                seen |= _filters(path)
    assert seen == {0, 1, 2, 4}


def _predict(ftype, left, up, up_left):
    if ftype == 1:
        return left
    if ftype == 2:
        return up
    if ftype == 3:
        return (left + up) // 2
    p = left + up - up_left
    pa, pb, pc = abs(p - left), abs(p - up), abs(p - up_left)
    return left if pa <= pb and pa <= pc else up if pb <= pc else up_left


def _write_filtered(path, px, color, ftype):
    """An 8-bit PNG of px (h, w, channels) with every row filtered by
    ftype, straight from the PNG specification."""
    h, w, ch = px.shape
    rows = px.reshape(h, w * ch).astype(int)
    raw = bytearray()
    for y in range(h):
        raw.append(ftype)
        for i in range(w * ch):
            left = rows[y, i - ch] if i >= ch else 0
            up = rows[y - 1, i] if y else 0
            up_left = rows[y - 1, i - ch] if y and i >= ch else 0
            pred = _predict(ftype, left, up, up_left) if ftype else 0
            raw.append((rows[y, i] - pred) % 256)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(raw)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
def test_each_row_filter_equals_pillow(tmp_path, ftype):
    rng = np.random.default_rng(ftype)
    for color, ch in ((0, 1), (2, 3), (4, 2), (6, 4)):
        px = rng.integers(0, 256, (13, 17, ch), dtype=np.uint8)
        path = str(tmp_path / f"c{color}.png")
        _write_filtered(path, px, color, ftype)
        assert _filters(path) == {ftype}
        np.testing.assert_array_equal(
            read_png_rgb(path), np.asarray(Image.open(path).convert("RGB")))


def _with_ihdr(path, out, depth=None, interlace=None):
    """A copy of the PNG at path with IHDR's bit depth or interlace byte
    replaced (the CRC is not checked by the reader)."""
    data = bytearray(open(path, "rb").read())
    if depth is not None:
        data[8 + 8 + 8] = depth
    if interlace is not None:
        data[8 + 8 + 12] = interlace
    open(out, "wb").write(bytes(data))


def test_unread_pngs_raise(tmp_path):
    arr = _image("ramp", 9, 11)
    Image.fromarray(arr[..., 0].astype(np.uint16) * 257).save(
        tmp_path / "grey16.png")
    with pytest.raises(ValueError, match="bit depth 16"):
        read_png_rgb(str(tmp_path / "grey16.png"))
    Image.fromarray(arr[..., 0] > 127).save(tmp_path / "bilevel.png")
    with pytest.raises(ValueError, match="bit depth 1"):
        read_png_rgb(str(tmp_path / "bilevel.png"))
    Image.fromarray(arr).save(tmp_path / "rgb.png")
    _with_ihdr(tmp_path / "rgb.png", tmp_path / "interlaced.png", interlace=1)
    with pytest.raises(ValueError, match="interlace 1"):
        read_png_rgb(str(tmp_path / "interlaced.png"))
    (tmp_path / "x.jpg").write_bytes(b"\xff\xd8\xff\xe0not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png_rgb(str(tmp_path / "x.jpg"))
