"""Nerfstudio interop parity: the port's utils/nerfstudio.py against the
JAX package's on the same files, cameras and arrays.

Tolerances: images bit-equal as float32 (the same decoded bytes through
the same numpy arithmetic); ray lengths, depths and unprojected points
bit-equal (the same float64 / float32 numpy arithmetic on the same
camera scalars); point clouds bit-equal; splits equal lists."""

import dataclasses
import json
import struct
import sys

import jax
import numpy as np
import pytest
from PIL import Image

from robosimgs_tpu.core.camera import Camera as JCamera
from robosimgs_tpu.utils import nerfstudio as jns

from robosimgs_tpu_torch.core.convert import camera_from_numpy
from robosimgs_tpu_torch.utils import nerfstudio as ns
from robosimgs_tpu_torch.utils.imresize import read_png_array

H, W = 23, 37
BACKGROUNDS = [(1.0, 1.0, 1.0), (0.2, 0.5, 0.9)]


def _pixels(mode: str) -> Image.Image:
    """A seeded image in the given Pillow mode, alpha spanning 0..255."""
    rng = np.random.default_rng(sum(map(ord, mode)))
    if mode == "P":
        img = Image.fromarray(rng.integers(0, 40, (H, W), dtype=np.uint8))
        img.putpalette(rng.integers(0, 256, 40 * 3, dtype=np.uint8).tolist())
        assert img.mode == "P"
        return img
    ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    arr = rng.integers(0, 256, (H, W, ch), dtype=np.uint8)
    if ch in (2, 4):
        arr[0, :, -1] = 0
        arr[1, :, -1] = 255
    img = Image.fromarray(arr[..., 0] if ch == 1 else arr)
    assert img.mode == mode
    return img


@pytest.mark.parametrize("background", BACKGROUNDS, ids=["white", "tint"])
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_load_image_with_background_matches_jax(tmp_path, mode, background):
    path = str(tmp_path / f"{mode}.png")
    _pixels(mode).save(path)
    want = jns.load_image_with_background(path, background)
    got = ns.load_image_with_background(path, background)
    assert got.dtype == np.float32 and want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # the reference's quirks, kept: LA comes back (H, W, 2) uncomposited,
    # P as its indices / 255 on 3 channels
    if mode == "LA":
        assert got.shape == (H, W, 2)
    if mode == "P":
        idx = np.asarray(Image.open(path)).astype(np.float32) / 255.0
        np.testing.assert_array_equal(got, np.stack([idx] * 3, -1))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_read_png_array_matches_pillow(tmp_path, mode):
    path = str(tmp_path / f"{mode}.png")
    _pixels(mode).save(path)
    want = np.asarray(Image.open(path))
    got = read_png_array(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_other_formats_go_through_pillow(tmp_path, monkeypatch):
    path = str(tmp_path / "rgb.jpg")
    _pixels("RGB").save(path, quality=90)
    np.testing.assert_array_equal(ns.load_image_with_background(path),
                                  jns.load_image_with_background(path))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError,
                       match=r"reading a \.jpg image needs Pillow"):
        ns.load_image_with_background(path)


def _cameras():
    jcam = JCamera.look_at([2.0, -1.0, 1.5], [0.1, 0.2, 0.0], [0, 0, 1],
                           50.0, W, H)
    # off-centre, non-square pixels: each scalar is read where it belongs
    jcam = dataclasses.replace(jcam, cx=jcam.cx + 1.3, fy=jcam.fy * 1.1)
    return jcam, camera_from_numpy(jax.device_get(jcam), "cpu")


def test_depth_distance_roundtrip_matches_jax():
    jcam, cam = _cameras()
    depth = np.random.default_rng(0).uniform(0.5, 4.0, (H, W)).astype(
        np.float32)
    dist = ns.depth_to_distance(depth, cam)
    np.testing.assert_array_equal(dist, jns.depth_to_distance(depth, jcam))
    np.testing.assert_array_equal(ns.distance_to_depth(dist, cam),
                                  jns.distance_to_depth(dist, jcam))
    np.testing.assert_allclose(ns.distance_to_depth(dist, cam), depth,
                               rtol=1e-6)
    assert (dist >= depth).all()


@pytest.mark.parametrize("u,v,depth", [(0.0, 0.0, 1.0), (17.0, 9.0, 2.5),
                                       (36.0, 22.0, 0.3)])
def test_unproject_pixel_matches_jax(u, v, depth):
    jcam, cam = _cameras()
    got = ns.unproject_pixel(u, v, depth, cam)
    want = jns.unproject_pixel(u, v, depth, jcam)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,frac,seed", [(10, 0.1, 0), (57, 0.25, 3),
                                         (1, 0.1, 0), (200, 0.0, 7)])
def test_scene_splits_match_jax(n, frac, seed):
    got = ns.scene_splits(n, frac, seed)
    assert got == jns.scene_splits(n, frac, seed)
    assert sorted(got[0] + got[1]) == list(range(n))


def _write_cloud(tmp_path):
    """A binary vertex-only PLY as Nerfstudio exports it (float xyz,
    uchar rgb; points on a coarse lattice, so voxels hold several) and a
    dataparser_transforms.json with a rotation, translation and scale."""
    rng = np.random.default_rng(1)
    pts = (rng.integers(-20, 20, (500, 3)) * 0.05
           + rng.uniform(0, 0.01, (500, 3))).astype(np.float32)
    rgb = rng.integers(0, 256, (500, 3), dtype=np.uint8)
    ply = tmp_path / "cloud.ply"
    header = ("ply\nformat binary_little_endian 1.0\nelement vertex 500\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty uchar green\nproperty uchar blue\n"
              "end_header\n").encode()
    body = b"".join(struct.pack("<fffBBB", *p, *c) for p, c in zip(pts, rgb))
    ply.write_bytes(header + body)
    a = 0.7
    T = [[np.cos(a), -np.sin(a), 0.0, 0.3], [np.sin(a), np.cos(a), 0.0, -0.2],
         [0.0, 0.0, 1.0, 0.5]]
    tf = tmp_path / "dataparser_transforms.json"
    tf.write_text(json.dumps({"transform": T, "scale": 0.37}))
    return str(ply), str(tf)


@pytest.mark.parametrize("voxel", [0.0, 0.1])
def test_load_points_denormalized_matches_jax(tmp_path, voxel):
    ply, tf = _write_cloud(tmp_path)
    got = ns.load_points_denormalized(ply, tf, voxel)
    want = jns.load_points_denormalized(ply, tf, voxel)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (len(got) < 500) == (voxel > 0)
