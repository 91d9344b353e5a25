"""The port's utils/pointcloud.py against the JAX package on the CPU: the
point-cloud cases of tests/test_utils.py, each also holding the port's
output against the JAX function's on the same points and cameras.
Pixel coordinates and points within 1e-4 (f32 projection through 4x4
matrices each package builds itself); depth maps equal up to 1e-6
relative, with the same empty pixels; mask flags equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosimgs_tpu.core.camera import Camera as JCamera
from robosimgs_tpu.utils import pointcloud as jpc
from robosimgs_tpu.utils.nerfstudio import unproject_pixel
from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.utils import pointcloud as pc


def make_cams(w=64, h=48):
    args = ([0, 0, -3], [0, 0, 0], [0, 1, 0], 60.0, w, h)
    return Camera.look_at(*args, device="cpu"), JCamera.look_at(*args)


def test_project_unproject_roundtrip(rng):
    cam, jcam = make_cams()
    pts = rng.uniform(-0.5, 0.5, (100, 3)).astype(np.float32)
    uv, z = pc.project_pcd(torch.as_tensor(pts), cam)
    juv, jz = jpc.project_pcd(jnp.asarray(pts), jcam)
    np.testing.assert_allclose(uv.numpy(), np.asarray(juv), atol=1e-4)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-6)
    back = pc.unproject_pcd(uv, z, cam)
    np.testing.assert_allclose(back.numpy(), pts, atol=1e-4)
    for to_world in (True, False):
        np.testing.assert_allclose(
            pc.unproject_pcd(uv, z, cam, to_world).numpy(),
            np.asarray(jpc.unproject_pcd(jnp.asarray(uv.numpy()),
                                         jnp.asarray(z.numpy()), jcam,
                                         to_world)), atol=1e-5)


def test_depth_map_from_points():
    cam, jcam = make_cams(32, 32)
    # two points on the optical axis; nearer one wins the z-buffer
    pts = np.array([[0, 0, 0], [0, 0, -1.0]], np.float32)
    d = pc.depth_map_from_points(torch.as_tensor(pts), cam,
                                 downscale=1).numpy()
    np.testing.assert_array_equal(
        d, np.asarray(jpc.depth_map_from_points(jnp.asarray(pts),
                                                        jcam, downscale=1)))
    uv, z = pc.project_pcd(torch.as_tensor(pts), cam)
    u, v = np.round(uv[1].numpy()).astype(int)
    assert np.isfinite(d[v, u])
    np.testing.assert_allclose(float(d[v, u]), float(z[1]), atol=1e-5)
    assert np.isinf(d[0, 0])


@pytest.mark.parametrize("downscale", [1, 2, 3])
def test_depth_map_from_many_points_matches_jax(downscale):
    """A few thousand points, some behind the camera and some off screen
    (the sink bin), several per pixel: the same z-buffer."""
    cam, jcam = make_cams(40, 30)
    pts = np.random.default_rng(downscale).uniform(
        -2.5, 2.5, (3000, 3)).astype(np.float32)
    pts[:200, 2] = -4.0                   # behind the camera at z = -3
    d = pc.depth_map_from_points(torch.as_tensor(pts), cam,
                                 downscale=downscale).numpy()
    jd = np.asarray(jpc.depth_map_from_points(jnp.asarray(pts), jcam,
                                              downscale=downscale))
    # a downscale that does not divide the size leaves the JAX map short
    # of the image by the remainder; the port keeps its shape
    assert d.shape == jd.shape
    np.testing.assert_array_equal(np.isinf(d), np.isinf(jd))
    fin = np.isfinite(d)
    assert fin.mean() > 0.5
    np.testing.assert_allclose(d[fin], jd[fin], rtol=1e-6)


def test_sample_mask_at_points():
    cam, jcam = make_cams(32, 32)
    mask = np.zeros((32, 32), np.float32)
    mask[:, :16] = 1.0   # left half of image
    pts = np.array([[-0.5, 0, 0], [0.5, 0, 0]], np.float32)
    flags = pc.sample_mask_at_points(torch.as_tensor(mask),
                                     torch.as_tensor(pts), cam).numpy()
    # camera right = cross(fwd=+z, up=+y) = -x, so world +0.5x is image-left
    assert flags.tolist() == [False, True]
    rng = np.random.default_rng(2)
    many = rng.uniform(-1.5, 1.5, (500, 3)).astype(np.float32)
    soft = rng.uniform(size=(32, 32)).astype(np.float32)
    np.testing.assert_array_equal(
        pc.sample_mask_at_points(torch.as_tensor(soft), torch.as_tensor(many),
                                 cam).numpy(),
        np.asarray(jpc.sample_mask_at_points(jnp.asarray(soft),
                                             jnp.asarray(many), jcam)))


def test_sample_mask_depth_consistency():
    cam, jcam = make_cams(32, 32)
    mask = np.ones((32, 32), np.float32)
    pts = np.array([[0, 0, 0], [0, 0, 1.0]], np.float32)
    # depth map from the nearer point only -> the farther is occluded
    dm = pc.depth_map_from_points(torch.as_tensor(pts[:1]), cam, downscale=1)
    dm = torch.where(torch.isinf(dm), torch.full_like(dm, 3.0), dm)
    flags = pc.sample_mask_at_points(torch.as_tensor(mask),
                                     torch.as_tensor(pts), cam,
                                     depth_map=dm).numpy()
    jflags = np.asarray(jpc.sample_mask_at_points(
        jnp.asarray(mask), jnp.asarray(pts), jcam,
        depth_map=jnp.asarray(dm.numpy())))
    assert flags.tolist() == jflags.tolist() == [True, False]


def test_unproject_pixel_consistent_with_pcd():
    """The JAX package's pixel unprojection, projected back by the port."""
    cam, jcam = make_cams()
    p = unproject_pixel(20.0, 10.0, 2.5, jcam)
    uv, z = pc.project_pcd(torch.as_tensor(np.asarray(p, np.float32)[None]),
                           cam)
    np.testing.assert_allclose(uv[0].numpy(), [20.0, 10.0], atol=1e-3)
    np.testing.assert_allclose(float(z[0]), 2.5, atol=1e-5)
