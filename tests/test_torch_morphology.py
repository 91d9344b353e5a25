"""utils/morphology.py against OpenCV and utils/imresize.py's resizes
against jax.image.resize, on the same numpy inputs.

Tolerances: dilation, erosion and the resizes' nearest mode exact; Sobel
exact (the same float32 additions) on images of three rows or more, one
ulp on a two-row one; the label stamp equal outside the box
cv2.getTextSize gives; the linear resize within 1e-6. The chamfer
distance is the same 0.955 / 1.3693 chamfer, but OpenCV 5 rounds some of
its sums otherwise than a float32 scan does: on masks of ~2,000 pixels a
few pixels (0.125 to 0.93 % measured) differ by one ulp; on 200x200 and
800x800 box masks up to 64 ulp (7.6e-6 relative measured) on ~15 % of pixels.
The segmenter reads the distance as min(d / tau, 1) with tau <= 10 px.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosimgs_tpu_torch.utils import morphology
from robosimgs_tpu_torch.utils.imresize import resize_linear, resize_nearest


def _masks(shape, seed):
    rng = np.random.default_rng(seed)
    h, w = shape
    touching = np.zeros(shape, bool)
    touching[: h // 3] = True                     # touches three borders
    touching[:, -2:] = True
    blobs = np.zeros(shape, bool)
    for _ in range(4):
        y, x = rng.integers(0, h), rng.integers(0, w)
        blobs[y:y + rng.integers(3, h), x:x + rng.integers(3, w)] = True
    return {"sparse": rng.random(shape) < 0.15,
            "dense": rng.random(shape) < 0.9,
            "touching": touching, "blobs": blobs,
            "empty": np.zeros(shape, bool), "full": np.ones(shape, bool)}


@pytest.mark.parametrize("px", [1, 2, 3, 10])
def test_dilate_erode_match_opencv(px):
    kernel = np.ones((px, px), np.uint8)
    for name, m in _masks((37, 53), px).items():
        u8 = m.astype(np.uint8)
        np.testing.assert_array_equal(morphology.dilate(m, px),
                                      cv2.dilate(u8, kernel) > 0, err_msg=name)
        np.testing.assert_array_equal(morphology.erode(m, px),
                                      cv2.erode(u8, kernel) > 0, err_msg=name)


def test_distance_transform_small_masks_within_one_ulp():
    masks = _masks((40, 60), 0)
    line = np.ones((31, 45), bool)
    line[15, 3:40] = False                        # a thin zero line
    line[:, 22] = False
    masks["lines"] = line
    masks["one_zero"] = np.ones((7, 9), bool)
    masks["one_zero"][3, 4] = False
    for name, m in masks.items():
        want = cv2.distanceTransform(m.astype(np.uint8), cv2.DIST_L2, 3)
        got = morphology.distance_transform_l2_3(m)
        assert got.dtype == np.float32
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
        assert (got != want).mean() <= 0.02, (name, (got != want).sum())
    # no zero pixel anywhere: FLT_MAX everywhere (the border is no zero)
    full = morphology.distance_transform_l2_3(np.ones((5, 5), bool))
    assert (full == np.finfo(np.float32).max).all()
    assert (morphology.distance_transform_l2_3(np.zeros((5, 5), bool))
            == 0).all()


@pytest.mark.parametrize("shape", [(200, 200), (800, 800)])
def test_distance_transform_large_masks_within_64_ulp(shape):
    rng = np.random.default_rng(1)
    m = np.zeros(shape, bool)
    for _ in range(5):
        y, x = rng.integers(0, shape[0], 2)
        m[y:y + rng.integers(10, shape[0]),
          x:x + rng.integers(10, shape[1])] = 1
    m |= rng.random(shape) < 0.002
    want = cv2.distanceTransform((~m).astype(np.uint8), cv2.DIST_L2, 3)
    got = morphology.distance_transform_l2_3(~m)
    np.testing.assert_array_max_ulp(got, want, maxulp=64)
    share = float((got != want).mean())
    assert share < 0.3, share


def test_sobel_matches_opencv():
    rng = np.random.default_rng(2)
    for shape in [(41, 57), (2, 5), (96, 96)]:
        g = rng.random(shape).astype(np.float32)
        for dx, dy in ((1, 0), (0, 1)):
            want = cv2.Sobel(g, cv2.CV_32F, dx, dy, ksize=3)
            got = morphology.sobel3(g, dx, dy)
            if shape[0] > 2:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_array_max_ulp(got, want, maxulp=1)
    with pytest.raises(ValueError):
        morphology.sobel3(g, 1, 1)


@pytest.mark.parametrize("height", [96, 128, 400, 800])
def test_label_stamp_inside_the_opencv_text_box(height):
    """The candidate grid's labels #1 .. #16 at the grid's own scale and
    origin: the port's stamp and cv2.putText agree outside the box
    cv2.getTextSize gives, and the stamp drew something inside it."""
    scale = max(0.5, height / 400)
    thick = max(1, int(2 * scale))
    org = (8, int(28 * scale))
    rng = np.random.default_rng(height)
    base = rng.integers(0, 256, (height, height, 3), dtype=np.uint8)
    for n in range(1, 17):
        text = f"#{n}"
        got = morphology.stamp_label(base.copy(), text, org, scale,
                                     (255, 25, 25))
        want = cv2.putText(base.copy(), text, org, cv2.FONT_HERSHEY_SIMPLEX,
                           scale, (255, 25, 25), thick, cv2.LINE_AA)
        (w, h), baseline = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX,
                                           scale, thick)
        box = np.zeros((height, height), bool)
        box[max(org[1] - h, 0):org[1] + baseline + 1, org[0]:org[0] + w] = True
        np.testing.assert_array_equal(got[~box], want[~box])
        assert (got[box] != base[box]).any()


@pytest.mark.parametrize("src,dst", [(800, 96), (347, 96), (48, 96),
                                     (96, 800)])
def test_resizes_match_jax(src, dst):
    rng = np.random.default_rng(src)
    img = rng.random((src, src, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (dst, dst, 3),
                                       "linear"))
    got = resize_linear(torch.from_numpy(img), dst, dst).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    mask = (rng.random((src, src)) < 0.5).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(mask), (dst, dst),
                                       "nearest"))
    np.testing.assert_array_equal(resize_nearest(mask, dst, dst), want)
    np.testing.assert_array_equal(
        resize_nearest(torch.from_numpy(mask), dst, dst).numpy(), want)


def test_resizes_crop_shapes_match_jax():
    """The prompted path's crops: non-square sources to 96 and back."""
    rng = np.random.default_rng(3)
    crop = rng.random((203, 150, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(crop), (96, 96, 3),
                                       "linear"))
    np.testing.assert_allclose(
        resize_linear(torch.from_numpy(crop), 96, 96).numpy(), want,
        atol=1e-6, rtol=0)
    m = (rng.random((96, 96)) < 0.5).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(m), (203, 150), "nearest"))
    np.testing.assert_array_equal(resize_nearest(m, 203, 150), want)
