"""The port's mask model (robosimgs_tpu_torch/artic/masknet.py and its
weights reader artic/flax_msgpack.py) against the JAX package on the CPU:
the same weights, numpy inputs and seeds go through both.

Tolerances: the weights reader and writer exact (leaf by leaf, and byte
for byte); scenes: rgb within 1e-5 where both cover, part ids flipped on
at most 0.1 % of pixels (mesh edges: XLA contracts the edge functions
into FMAs, torch does not); sample_example exact without crops, within
1e-6 with them. Logits: flax's GroupNorm takes E[x^2] - E[x]^2 from f32
means summed in XLA's order; on the renders' flat white background the
first layer's |mean| / std reaches 8, and the difference cancels, so the
JAX logits carry ~5e-3 of rounding (the port sums those statistics in
float64). The forward is held within 1e-2 of the JAX logits on the
generator's inputs (4.3e-3 measured, no thresholded pixel flipped) and
within 1e-3 on uniform noise (1.2e-4 measured); the generator's masks
flip at most 0.1 % of their pixels. Three AdamW updates: the losses
within 1e-4 relative; all but 0.1 % of the entries within 1e-5 of the
largest parameter (139 of 1,225,313 beyond it measured), every entry
within 1e-3 (2.8e-4 measured: Adam's first steps are ~lr in the sign of
a gradient that may round to either side of 0).
"""

import hashlib

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosimgs_tpu.artic import masknet as jm
from robosimgs_tpu_torch.artic import flax_msgpack
from robosimgs_tpu_torch.artic import masknet as pm
from robosimgs_tpu_torch.core.convert import (masknet_params_from_numpy,
                                              masknet_params_to_numpy)

MAX_FLIP_SHARE = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # the suite runs files in parallel workers, where torch's CPU threads
    # spin against each other (the training fixture took 640 s with them)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


@pytest.fixture(scope="module")
def jparams():
    return jm.load_params()


@pytest.fixture(scope="module")
def japply():
    return jax.jit(jm.MaskUNet().apply)


def port_model(params=None):
    model = pm.MaskUNet()
    model.load_state_dict(params if params is not None else pm.load_params())
    return model.eval()


# -- weights -----------------------------------------------------------------

def test_weights_copy_is_the_jax_file():
    digests = [hashlib.sha256(open(p, "rb").read()).hexdigest()
               for p in (jm.DEFAULT_WEIGHTS, pm.DEFAULT_WEIGHTS)]
    assert digests[0] == digests[1]


def test_weights_reader_matches_flax():
    data = open(pm.DEFAULT_WEIGHTS, "rb").read()
    got = dict(_leaves(flax_msgpack.loads(data)))
    want = dict(_leaves(flax.serialization.msgpack_restore(data)))
    assert list(got) == list(want) and len(got) == 70
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the writer packs the tree back to the same bytes
    assert flax_msgpack.dumps(flax_msgpack.loads(data)) == data


@pytest.mark.parametrize("blob", [b"\xc1", b"\xd4\x02\x00", b"\x91",
                                  b"\x01\x02"],
                         ids=["never_used", "ext_type_2", "truncated",
                              "trailing"])
def test_weights_reader_rejects_what_it_does_not_read(blob):
    with pytest.raises(ValueError, match="msgpack"):
        flax_msgpack.loads(blob)


def test_params_convert_names_and_layouts(jparams):
    sd = masknet_params_from_numpy(jax.device_get(jparams))
    assert sd["convs.10.weight"].shape == (128, 256, 3, 3)
    assert sd["norms.16.weight"].shape == (16,)
    # the port's module takes the converted dict as its own
    assert set(sd) == set(pm.MaskUNet().state_dict())
    back = masknet_params_to_numpy(sd)
    for (k, a), (k2, b) in zip(_leaves(back),
                               _leaves(jax.device_get(jparams))):
        assert k == k2
        np.testing.assert_array_equal(a, b)


def test_save_params_round_trip_through_jax(tmp_path, jparams):
    sd = pm.load_params()
    path = str(tmp_path / "w.msgpack")
    pm.save_params(sd, path)
    assert open(path, "rb").read() == open(pm.DEFAULT_WEIGHTS, "rb").read()
    loaded = jm.load_params(path, size=64)
    for (k, a), (_, b) in zip(_leaves(jax.device_get(loaded)),
                              _leaves(jax.device_get(jparams))):
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k, v in pm.load_params(path).items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


# -- the forward --------------------------------------------------------------

def _generator_inputs(size=96):
    rng = np.random.default_rng(3)
    xs = []
    for s in range(4):
        img, pid = pm.make_scene(2000 + s, size, scan_like=s % 2 == 1,
                                 flap=s >= 2, device="cpu")
        xs.append(pm.sample_example(rng, img, pid)[0])
    return np.stack(xs)


@pytest.mark.parametrize("inputs,atol", [("scenes", 1e-2), ("uniform", 1e-3)])
def test_forward_matches_jax(jparams, japply, inputs, atol):
    if inputs == "scenes":
        x = _generator_inputs()
    else:
        x = np.random.default_rng(0).uniform(
            size=(4, 96, 96, 4)).astype(np.float32)
    with torch.no_grad():
        got = port_model()(torch.from_numpy(x)).numpy()
    want = np.asarray(japply(jparams, jnp.asarray(x)))
    assert got.shape == want.shape == (4, 96, 96)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    flips = float(((got > 0) != (want > 0)).mean())
    assert flips <= MAX_FLIP_SHARE, flips


def test_init_draws_flax_distributions():
    """Its own initialisation: lecun-normal kernels (truncated at two
    standard deviations, variance 1 / fan_in), zero biases, unit scales."""
    sd = pm.MaskUNet(generator=torch.Generator().manual_seed(1)).state_dict()
    w = sd["convs.10.weight"]
    std = (1.0 / (9 * 256)) ** 0.5
    assert abs(float(w.std()) / std - 1.0) < 0.05
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
    assert all(float(sd[f"convs.{i}.bias"].abs().max()) == 0
               for i in range(18))
    assert all(bool((sd[f"norms.{i}.weight"] == 1).all()) for i in range(17))


# -- scenes and examples ------------------------------------------------------

@pytest.mark.parametrize("flap", [False, True])
def test_make_scene_matches_jax(flap):
    img, pid = pm.make_scene(4242, 64, scan_like=flap, flap=flap,
                             device="cpu")
    jimg, jpid = jm.make_scene(4242, 64, scan_like=flap, flap=flap)
    flips = float((pid != jpid).mean())
    assert flips <= MAX_FLIP_SHARE, flips
    both = (pid >= 0) & (jpid >= 0)
    np.testing.assert_allclose(img[both], jimg[both], atol=1e-5)
    assert len(np.unique(pid[pid >= 0])) >= 2


@pytest.mark.parametrize("crop_aug", [False, True])
def test_sample_example_matches_jax(crop_aug):
    img, pid = pm.make_scene(2001, 64, scan_like=True, device="cpu")
    for seed in range(6):
        x, y = pm.sample_example(np.random.default_rng(seed), img, pid,
                                 crop_aug=crop_aug)
        jx, jy = jm.sample_example(np.random.default_rng(seed), img, pid,
                                   crop_aug=crop_aug)
        assert x.dtype == np.float32 and x.shape == (64, 64, 4)
        if crop_aug:
            np.testing.assert_allclose(x, jx, atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


# -- training -----------------------------------------------------------------

def test_three_updates_match_jax(jparams, monkeypatch):
    """train_masknet from the JAX parameters in both packages, on the
    same scenes (the port's, handed to the JAX trainer, whose own scenes
    the make_scene test holds equal) and so the same numpy batches:
    AdamW with optax's defaults under the cosine decay, BCE + dice."""
    def scene(seed, size, max_parts=3, scan_like=False, flap=False):
        return pm.make_scene(seed, size, max_parts, scan_like, flap,
                             device="cpu")

    monkeypatch.setattr(jm, "make_scene", scene)
    kw = dict(steps=3, size=32, batch=4, n_scenes=3, seed=5)
    want = jm.train_masknet(init_params=jparams, **kw)
    got = pm.train_masknet(init_params=pm.load_params(), device="cpu", **kw)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    wtree = masknet_params_from_numpy(jax.device_get(want.params))
    scale = max(float(v.abs().max()) for v in wtree.values())
    start = pm.load_params()
    diff = torch.cat([(v - wtree[k]).abs().flatten()
                      for k, v in got.params.items()])
    moved = max(float((v - start[k]).abs().max())
                for k, v in got.params.items())
    assert moved > 1e-3          # the updates did move the weights
    # an entry whose gradient rounds to either side of 0 takes Adam's
    # first steps (~lr each) in opposite directions
    assert float(diff.max()) <= 1e-3, float(diff.max())
    far = float((diff > 1e-5 * scale).float().mean())
    assert far <= 1e-3, far


def test_cosine_lr_matches_optax():
    import optax
    sched = optax.cosine_decay_schedule(2e-3, 7)
    for c in range(9):
        assert pm.cosine_lr(2e-3, 7, c) == pytest.approx(float(sched(c)),
                                                         rel=1e-6, abs=1e-12)


# -- the generator ------------------------------------------------------------

def _assert_masks_agree(got, want):
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g.dtype == bool and g.shape == w.shape
        assert (g != w).mean() <= MAX_FLIP_SHARE, (g != w).mean()


@pytest.mark.parametrize("prompted", [False, True])
def test_generator_matches_jax(jparams, prompted):
    """MaskNetGenerator.generate on a 128 px scene (resized to the net's
    96) with the checked-in weights, automatic and point-prompted."""
    img, pid = pm.make_scene(555_000, 128, device="cpu")
    point = None
    if prompted:
        present, counts = np.unique(pid[pid >= 0], return_counts=True)
        ys, xs = np.nonzero(pid == present[np.argmax(counts)])
        point = (float(np.median(xs)), float(np.median(ys)))
    got = pm.MaskNetGenerator(device="cpu").generate(img, point=point)
    want = jm.MaskNetGenerator(jparams).generate(img, point=point)
    _assert_masks_agree(got, want)


def test_generator_batch_is_one_forward(monkeypatch):
    """All grid prompts go through the net in one batch (B <= grid^2)."""
    gen = pm.MaskNetGenerator(device="cpu")
    calls = []
    real = gen.probs
    monkeypatch.setattr(gen, "probs",
                        lambda x: calls.append(x.shape) or real(x))
    img, _ = pm.make_scene(555_001, 96, device="cpu")
    gen.generate(img)
    assert len(calls) == 1 and 1 <= calls[0][0] <= 36
    assert calls[0][1:] == (96, 96, 4)


def test_entry_points_default_to_cuda():
    import inspect

    from robosimgs_tpu_torch.artic.segmentation import Segmenter
    for fn in (pm.MaskNetGenerator, pm.make_scene, pm.train_masknet,
               Segmenter):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            pm.MaskNetGenerator()


# -- the JAX package's tests of the model, on the port ------------------------

@pytest.fixture(scope="module")
def trained():
    # short CPU training run: enough to learn prompt->part association
    return pm.train_masknet(steps=150, size=64, batch=8, n_scenes=24, seed=0,
                            device="cpu")


def test_masknet_learns(trained):
    assert trained.losses[-1] < trained.losses[0] * 0.5, (
        trained.losses[0], trained.losses[-1])
    assert trained.holdout_iou > 0.45, trained.holdout_iou


def test_masknet_automatic_generation(trained):
    gen = pm.MaskNetGenerator(trained.params, size=64, grid=5, device="cpu")
    img, pid = pm.make_scene(555_000, 64, device="cpu")
    masks = gen.generate(img)
    assert len(masks) >= 1
    for m in masks:
        assert m.shape == img.shape[:2] and m.dtype == bool
    best = 0.0
    for p in np.unique(pid[pid >= 0]):
        gt = pid == p
        for m in masks:
            best = max(best, (m & gt).sum() / max((m | gt).sum(), 1))
    assert best > 0.4, best
    # upsampling path: full-res input
    img_big = np.kron(img, np.ones((2, 2, 1), np.float32)).astype(np.float32)
    masks_big = gen.generate(img_big)
    assert masks_big and masks_big[0].shape == img_big.shape[:2]


def test_masknet_segmenter_integration(trained):
    """The learned model drives Segmenter.segment_part end to end
    (marker-containment selection, the scripted pipeline mode)."""
    from robosimgs_tpu_torch.artic.segmentation import Segmenter
    from robosimgs_tpu_torch.utils.meshio import Mesh

    img, pid = pm.make_scene(777_000, 64, device="cpu")
    present, counts = np.unique(pid[pid >= 0], return_counts=True)
    p = int(present[np.argmax(counts)])      # largest visible part
    ys, xs = np.nonzero(pid == p)
    cy, cx = int(np.median(ys)), int(np.median(xs))
    dummy = Mesh(vertices=np.zeros((3, 3), np.float32),
                 faces=np.array([[0, 1, 2]], np.int32))
    seg = Segmenter(dummy, mask_generator=pm.MaskNetGenerator(
        trained.params, size=64, grid=5, device="cpu"), mask_dilate_px=0,
        min_mask_area=0.01, device="cpu")
    mask = seg.segment_part(img, "part", marker_uv=(cx, cy))
    assert mask.dtype == bool and mask.shape == img.shape[:2]
    gt = pid == p
    assert (mask & gt).sum() / max((mask | gt).sum(), 1) > 0.2


def test_masknet_save_load(trained, tmp_path):
    path = str(tmp_path / "w.msgpack")
    pm.save_params(trained.params, path)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(1, 64, 64, 4)).astype(np.float32))
    with torch.no_grad():
        a = port_model(trained.params)(x)
        b = port_model(pm.load_params(path))(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
