"""Data parity: the port's train/data.py, utils copies and KNN scale
init against the JAX package's on the same files and points."""

import json
import struct

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from robosimgs_tpu.core.types import Gaussians as JGaussians
from robosimgs_tpu.core.types import _knn_mean_dist
from robosimgs_tpu.train import data as jdata
from robosimgs_tpu.utils.colmap import load_colmap as jload_colmap

from robosimgs_tpu_torch.core.types import Gaussians, knn_mean_dist
from robosimgs_tpu_torch.train import data as tdata
from robosimgs_tpu_torch.utils.colmap import load_colmap


def _assert_cameras(cam, jcam):
    for k in ("fx", "fy", "cx", "cy", "c2w"):
        np.testing.assert_allclose(getattr(cam, k).numpy(),
                                   np.asarray(getattr(jcam, k)), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert (cam.width, cam.height) == (jcam.width, jcam.height)


def _write_capture(root):
    """A transforms.json with top-level OPENCV distortion, one frame that
    overrides it with a fisheye model, a depth file and RGBA images."""
    rng = np.random.default_rng(0)
    frames = []
    for i in range(3):
        ang = 2 * np.pi * i / 3
        c2w = np.eye(4)
        c2w[:3, 3] = [3 * np.cos(ang), 3 * np.sin(ang), 1.0]
        fr = {"file_path": f"img_{i}", "transform_matrix": c2w.tolist()}
        rgba = (rng.uniform(0, 1, (24, 32, 4)) * 255).astype(np.uint8)
        Image.fromarray(rgba).save(root / f"img_{i}.png")
        if i == 1:
            fr.update(camera_model="OPENCV_FISHEYE", k1=0.05, k2=-0.01)
        if i == 2:
            np.save(root / "depth_2.npy",
                    rng.uniform(1, 3, (24, 32)).astype(np.float32))
            fr["depth_file_path"] = "depth_2.npy"
        frames.append(fr)
    meta = {"fl_x": 30.0, "fl_y": 31.0, "cx": 16.0, "cy": 12.0, "w": 32,
            "h": 24, "k1": -0.1, "k2": 0.02, "p1": 0.001, "p2": -0.002,
            "frames": frames}
    path = root / "transforms.json"
    path.write_text(json.dumps(meta))
    return str(path)


@pytest.mark.parametrize("downscale", [1, 2])
def test_parse_transforms_json_matches_jax(tmp_path, downscale):
    path = _write_capture(tmp_path)
    want = jdata.parse_transforms_json(path, downscale=downscale)
    got = tdata.parse_transforms_json(path, downscale=downscale, device="cpu")
    assert len(got) == len(want) == 3
    bg = (0.2, 0.4, 0.6)
    for f, jf in zip(got, want):
        _assert_cameras(f.camera, jf.camera)
        assert f.image_path == jf.image_path
        assert f.depth_path == jf.depth_path
        np.testing.assert_array_equal(f.distortion, jf.distortion)
        # RGBA over the background, resized, undistorted
        np.testing.assert_allclose(f.load(bg), jf.load(bg), atol=1e-6)
        jd = jf.load_depth()
        if jd is None:
            assert f.load_depth() is None
        else:
            np.testing.assert_array_equal(f.load_depth(), jd)
    assert got[1].distortion[8] == 1.0            # the frame's fisheye
    assert np.abs(got[0].distortion[:4]).sum() > 0
    np.testing.assert_allclose(tdata.camera_extent(got),
                               jdata.camera_extent(want), rtol=1e-6)


def test_dataparser_and_split_match_jax(tmp_path):
    T = np.eye(4)[:3]
    T[:, 3] = [0.1, -0.2, 0.3]
    p = tmp_path / "dataparser_transforms.json"
    p.write_text(json.dumps({"transform": T.tolist(), "scale": 0.5}))
    tT, ts = tdata.parse_dataparser_transforms(str(p))
    jT, js = jdata.parse_dataparser_transforms(str(p))
    np.testing.assert_array_equal(tT, jT)
    assert ts == js
    pts = np.random.default_rng(1).normal(size=(10, 3)).astype(np.float32)
    np.testing.assert_array_equal(tdata.denormalize_points(pts, tT, ts),
                                  jdata.denormalize_points(pts, jT, js))
    tr, ev = tdata.train_eval_split(list(range(16)), 8)
    assert (tr, ev) == jdata.train_eval_split(list(range(16)), 8)


def test_colmap_matches_jax(tmp_path):
    sparse = tmp_path / "sparse"
    sparse.mkdir()
    with open(sparse / "cameras.bin", "wb") as fh:
        fh.write(struct.pack("<Q", 1))
        fh.write(struct.pack("<iiQQ", 1, 2, 64, 48))   # SIMPLE_RADIAL
        fh.write(struct.pack("<4d", 80.0, 32.0, 24.0, -0.2))
    with open(sparse / "images.bin", "wb") as fh:
        fh.write(struct.pack("<Q", 2))
        for i, t in enumerate([(0.0, 0.0, 0.0), (1.0, 0.0, 0.0)]):
            fh.write(struct.pack("<idddddddi", i + 1, 1.0, 0, 0, 0, *t, 1))
            fh.write(f"img_{i}.png".encode() + b"\x00")
            fh.write(struct.pack("<Q", 0))
    with open(sparse / "points3D.bin", "wb") as fh:
        fh.write(struct.pack("<Q", 2))
        for i in range(2):
            fh.write(struct.pack("<QdddBBBd", i, float(i), 0.0, 2.0, 255, 128,
                                 0, 0.5))
            fh.write(struct.pack("<Q", 0))
    got, xyz, rgb = load_colmap(str(sparse), "imgs", device="cpu")
    want, jxyz, jrgb = jload_colmap(str(sparse), "imgs")
    for f, jf in zip(got, want):
        _assert_cameras(f.camera, jf.camera)
        np.testing.assert_array_equal(f.distortion, jf.distortion)
        assert f.image_path == jf.image_path
    np.testing.assert_array_equal(xyz, jxyz)
    np.testing.assert_array_equal(rgb, jrgb)


@pytest.mark.parametrize("n", [1, 2, 5, 700])
def test_knn_scale_init_matches_numpy(n):
    pts = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    if n > 5:
        pts[3] = pts[2]                    # a duplicate: clipped, not 0
    got = knn_mean_dist(torch.from_numpy(pts), k=3).numpy()
    np.testing.assert_allclose(got, _knn_mean_dist(pts, k=3), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("planar", [False, True], ids=["cloud", "planar"])
def test_knn_matches_the_native_knn(planar):
    """core/types.py::knn_mean_dist on the device covers the JAX
    package's host C++ 3-NN (robosimgs_tpu.native, a grid hash; numpy
    where it cannot build), at tests/test_native.py's tolerance."""
    from robosimgs_tpu.native import knn_mean_dist as native_knn
    pts = np.random.default_rng(11).normal(size=(3000, 3)).astype(np.float32)
    if planar:
        pts[:, 2] = 0.0
    got = knn_mean_dist(torch.from_numpy(pts), k=3).numpy()
    np.testing.assert_allclose(got, native_knn(pts, k=3), rtol=1e-4,
                               atol=1e-6)


def test_from_points_without_init_scale_matches_jax():
    pts = np.random.default_rng(3).uniform(-1, 1, (50, 3)).astype(np.float32)
    cols = np.random.default_rng(4).uniform(0, 1, (50, 3)).astype(np.float32)
    g = Gaussians.from_points(pts, cols, sh_degree=2, capacity=64,
                              device="cpu")
    jg = JGaussians.from_points(pts, cols, sh_degree=2, capacity=64,
                                init_scale=_knn_mean_dist(pts, k=3))
    jg = jax.device_get(jg)
    for name in ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
                 "sh_rest", "alive"):
        np.testing.assert_allclose(getattr(g, name).numpy(),
                                   np.asarray(getattr(jg, name)), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_synthetic_scene_and_mesh_scene():
    gt, frames = tdata.synthetic_scene(0, 30, 4, 32, 24, device="cpu")
    jgt, jframes = jdata.synthetic_scene(0, 30, 4, 32, 24)
    assert gt.capacity == 30 and gt.sh_degree == 2
    for f, jf in zip(frames, jframes):      # the same camera ring
        _assert_cameras(f.camera, jf.camera)
    again, _ = tdata.synthetic_scene(0, 30, 4, 32, 24, device="cpu")
    assert torch.equal(gt.means, again.means)
    # the multi-box mesh scene: the same mesh from the same seed, images
    # and depth targets within 1e-5 but for at most 0.1 % of the pixels
    # (centers within f32 rounding of a triangle edge)
    mesh, mframes = tdata.synthetic_mesh_scene(0, 2, 48, 32, with_depth=True,
                                               device="cpu")
    jmesh, jmframes = jdata.synthetic_mesh_scene(0, 2, 48, 32, with_depth=True)
    np.testing.assert_array_equal(mesh.vertices, jmesh.vertices)
    np.testing.assert_array_equal(mesh.vertex_colors, jmesh.vertex_colors)
    for f, jf in zip(mframes, jmframes):
        _assert_cameras(f.camera, jf.camera)
        off = ((np.abs(f.image - jf.image) > 1e-5).any(-1)
               | (np.abs(f.depth - jf.depth) > 1e-5))
        assert off.mean() <= 1e-3, int(off.sum())
        assert (f.depth > 0).mean() > 0.2 and f.image.min() < 0.9
