"""Policy-stage parity: the port's diffusion policy (policy/diffusion.py,
policy/trainer.py), ActionChunker, closed-loop evaluation, image resize
and train_policy CLI against the JAX package's on the same numpy inputs,
with the flax parameters carried across by
core/convert.policy_params_from_numpy and the JAX draws (t, noise, x_T)
fed to both sides."""

import dataclasses
import functools
import inspect
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from robosimgs_tpu.core.camera import Camera as JCamera
from robosimgs_tpu.core.types import Gaussians as JGaussians
from robosimgs_tpu.policy import diffusion as jdiff
from robosimgs_tpu.policy import trainer as jtrainer
from robosimgs_tpu.policy.inference import ActionChunker as JChunker
from robosimgs_tpu.policy.rollout_eval import run_closed_loop as jclosed_loop
from robosimgs_tpu.render.config import RenderConfig as JConfig
from robosimgs_tpu.scenegen.rollout import ArticulatedObject as JObject

from robosimgs_tpu_torch.cli import train_policy as cli_policy
from robosimgs_tpu_torch.core.convert import (camera_from_numpy,
                                              gaussians_from_numpy,
                                              policy_params_from_numpy)
from robosimgs_tpu_torch.policy import diffusion, trainer
from robosimgs_tpu_torch.policy.inference import ActionChunker
from robosimgs_tpu_torch.policy.rollout_eval import run_closed_loop
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.scenegen.rollout import ArticulatedObject
from robosimgs_tpu_torch.utils.imresize import read_png_rgb, resize_bicubic

sys.path.insert(0, os.path.dirname(__file__))
from test_policy import SMALL as JSMALL, toy_dataset  # noqa: E402
from test_scenegen import BOX_URDF, box_mesh  # noqa: E402

SMALL = diffusion.DiffusionPolicyConfig(**dataclasses.asdict(JSMALL))
FULL = dict(action_dim=1, state_dim=1)        # the defaults, one joint
# pixels whose mesh coverage may differ between the packages (XLA
# contracts the mesh edge functions into FMAs; the rollout tolerance of
# tests/test_torch_scenegen.py)
EDGE_FRAC = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(ss, **kw):
    base = dataclasses.asdict(JSMALL) if not kw else {}
    base.update(kw, spatial_softmax=ss)
    return jdiff.DiffusionPolicyConfig(**base), \
        diffusion.DiffusionPolicyConfig(**base)


def _inputs(cfg, b=3, seed=0):
    rng = np.random.default_rng(seed)
    H, W = cfg.image_size
    return (rng.uniform(size=(b, cfg.obs_horizon, H, W, 3)).astype(np.float32),
            rng.normal(size=(b, cfg.obs_horizon, cfg.state_dim)
                       ).astype(np.float32),
            rng.normal(size=(b, cfg.horizon, cfg.action_dim)).astype(np.float32),
            rng.integers(0, cfg.diffusion_steps, b).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _jax_params(jcfg, seed):
    """Params of the JAX model's tree (its shapes by jax.eval_shape) drawn
    with numpy: kernels N(0, 1/fan_in), biases, LayerNorm scales and
    ss_log_temp off their initial values so that every entry's mapping
    is exercised; shared by the tests (read only)."""
    img, st, act, t = _inputs(jcfg, b=1)
    shapes = jax.eval_shape(jdiff.DiffusionPolicy(jcfg).init,
                            jax.random.PRNGKey(0), img, st, act, t)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        n = rng.normal(size=leaf.shape)
        if name == "kernel":
            n = n / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            n = 1.0 + 0.1 * n
        else:
            n = 0.1 * n
        return n.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _models(jcfg, tcfg, seed=1):
    """The JAX model, its params and the port's model with those params."""
    params = _jax_params(jcfg, seed)
    tm = diffusion.DiffusionPolicy(tcfg)
    tm.load_state_dict(policy_params_from_numpy(params))
    return jdiff.DiffusionPolicy(jcfg), params, tm


def _t(x):
    return torch.from_numpy(np.array(x))


def test_time_embedding_and_schedule():
    """Embedding, schedule and add_noise at atol 1e-6. XLA's f32 exp and
    torch's round about 1 in 8 of the frequencies to neighbouring floats,
    and an ulp of a frequency near 1 moves sin(t f) by t ulps: the
    embedding is held at 1e-6 up to t = 7 and within 1e-6 + t 2^-23
    beyond."""
    t = np.arange(100, dtype=np.int32)
    for dim in (32, 256):
        got = diffusion.cosine_time_embedding(_t(t), dim).numpy()
        want = np.asarray(jdiff.cosine_time_embedding(jnp.asarray(t), dim))
        np.testing.assert_allclose(got[:8], want[:8], atol=1e-6)
        assert (np.abs(got - want)
                <= 1e-6 + t[:, None] * 2.0 ** -23).all()
    js = jdiff.NoiseSchedule.make(JSMALL)
    ts = diffusion.NoiseSchedule.make(SMALL, "cpu")
    np.testing.assert_allclose(ts.betas.numpy(), np.asarray(js.betas),
                               atol=1e-6)
    np.testing.assert_allclose(ts.alphas_cumprod.numpy(),
                               np.asarray(js.alphas_cumprod), atol=1e-6)
    _, _, act, tt = _inputs(JSMALL)
    noise = np.random.default_rng(1).normal(size=act.shape).astype(np.float32)
    np.testing.assert_allclose(
        ts.add_noise(_t(act), _t(noise), _t(tt).long()).numpy(),
        np.asarray(js.add_noise(act, noise, tt)), atol=1e-6)


@pytest.mark.parametrize("ss", [False, True], ids=["gap", "spatial_softmax"])
@pytest.mark.parametrize("width", ["small", "full"])
def test_forward_matches_jax(ss, width):
    jcfg, tcfg = _cfgs(ss) if width == "small" else _cfgs(ss, **FULL)
    jm, params, tm = _models(jcfg, tcfg)
    img, st, act, t = _inputs(jcfg)
    want = np.asarray(jax.jit(jm.apply)(params, img, st, act, t))
    with torch.no_grad():
        got = tm(_t(img), _t(st), _t(act), _t(t)).numpy()
    assert got.shape == (3, jcfg.horizon, jcfg.action_dim)
    tol = dict(atol=2e-5, rtol=1e-4) if width == "small" else \
        dict(atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(got, want, **tol)


def test_init_is_flax_lecun_normal():
    """Fresh weights have flax's statistics: lecun_normal kernels
    (normal truncated at 2 sigma, variance 1/fan_in, the conv fan-in
    3*3*C_in), zero biases, LayerNorm scale 1, ss_log_temp 0."""
    jcfg, tcfg = _cfgs(True)
    want = policy_params_from_numpy(jax.device_get(
        jdiff.DiffusionPolicy(jcfg).init(jax.random.PRNGKey(1),
                                         *_inputs(jcfg, b=1))))
    sd = diffusion.DiffusionPolicy(tcfg,
                                   torch.Generator().manual_seed(5)).state_dict()
    assert sd.keys() == want.keys()
    for k, w in want.items():
        g = sd[k]
        assert g.shape == w.shape, k
        if not k.endswith("weight") or "norm" in k:
            assert torch.equal(g, w), k
            continue
        fan_in = int(np.prod(g.shape[1:]))
        std = np.sqrt(1.0 / fan_in)
        assert float(g.abs().max()) <= 2 * std / 0.8796256610342398 + 1e-6, k
        if g.numel() >= 1000:
            assert abs(float(g.std()) / std - 1) < 0.1, k
            assert abs(float(w.std()) / std - 1) < 0.1, k


@pytest.mark.parametrize("ss", [False, True], ids=["gap", "spatial_softmax"])
def test_loss_and_grads_match_jax(ss):
    jcfg, tcfg = _cfgs(ss)
    jm, params, tm = _models(jcfg, tcfg)
    img, st, act, _ = _inputs(jcfg, b=4, seed=2)
    # the JAX train step's draws
    _, k1, k2, _ = jax.random.split(jax.random.PRNGKey(7), 4)
    t = np.asarray(jax.random.randint(k1, (4,), 0, jcfg.diffusion_steps))
    noise = np.asarray(jax.random.normal(k2, act.shape))
    sched = jdiff.NoiseSchedule.make(jcfg)

    def loss_fn(p):
        pred = jm.apply(p, img, st, sched.add_noise(act, noise, t), t)
        return jnp.mean((pred - noise) ** 2)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss = trainer.policy_loss(tm, _t(img), _t(st), _t(act), _t(t).long(),
                               _t(noise),
                               diffusion.NoiseSchedule.make(tcfg, "cpu"))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = policy_params_from_numpy(jax.device_get(jgrads))
    got = dict(tm.named_parameters())
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = float(w.abs().max())
        err = float((got[k].grad - w).abs().max())
        assert err <= 1e-4 * scale, (k, err, scale)


def _trainers(cfg_kw, ds, seed=0):
    """The JAX trainer and the port's (on the CPU) on one dataset, the
    port's weights and EMA set to the JAX trainer's initial params."""
    jcfg = jtrainer.PolicyTrainConfig(policy=JSMALL, **cfg_kw)
    tcfg = trainer.PolicyTrainConfig(policy=SMALL, **cfg_kw)
    jtr = jtrainer.PolicyTrainer(jcfg, ds, seed=seed)
    tr = trainer.PolicyTrainer(tcfg, ds, seed=seed, device="cpu")
    sd = policy_params_from_numpy(jax.device_get(jtr.params))
    tr.model.load_state_dict(sd)
    tr.ema_model.load_state_dict(sd)
    return jtr, tr


def test_adamw_and_ema_match_optax():
    """Three updates from the same gradients: params, EMA and both Adam
    moments against the JAX trainer's optax.adamw under its
    warmup-cosine schedule, across the warmup boundary (lr 0, then half,
    then the peak)."""
    jtr, tr = _trainers(dict(lr=1e-2, weight_decay=1e-2, warmup_steps=2,
                             total_steps=10, ema_decay=0.9), toy_dataset())
    assert [trainer.lr_at(tr.cfg, c) for c in range(3)] == [0.0, 5e-3, 1e-2]
    @jax.jit
    def jstep(grads, opt_state, params, ema):   # the JAX trainer's update
        updates, opt_state = jtr.optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = jax.tree_util.tree_map(lambda e, p: 0.9 * e + 0.1 * p, ema,
                                     params)
        return opt_state, params, ema

    params, opt_state, ema = jtr.params, jtr.opt_state, jtr.ema_params
    rng = np.random.default_rng(3)
    named = dict(tr.model.named_parameters())
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: rng.normal(size=x.shape).astype(np.float32), params)
        for k, g in policy_params_from_numpy(jax.device_get(grads)).items():
            named[k].grad = g.clone()
        tr.apply_update()
        opt_state, params, ema = jstep(grads, opt_state, params, ema)
    adam = opt_state[0]
    want = {
        "params": policy_params_from_numpy(jax.device_get(params)),
        "ema": policy_params_from_numpy(jax.device_get(ema)),
        "mu": policy_params_from_numpy(jax.device_get(adam.mu)),
        "nu": policy_params_from_numpy(jax.device_get(adam.nu)),
    }
    assert int(adam.count) == tr.count == 3
    ema_named = dict(tr.ema_model.named_parameters())
    for k, p in named.items():
        st = tr.optimizer.state[p]
        for what, got in (("params", p), ("ema", ema_named[k]),
                          ("mu", st["exp_avg"]), ("nu", st["exp_avg_sq"])):
            np.testing.assert_allclose(got.detach().numpy(),
                                       want[what][k].numpy(), atol=1e-6,
                                       err_msg=f"{what} {k}")


def test_batches_match_jax_trainer(monkeypatch):
    """The same window indices and host batches as the JAX trainer's run
    for a seed (numpy's default_rng on both sides)."""
    ds = toy_dataset()
    jtr, tr = _trainers(dict(batch_size=8), ds, seed=4)
    seen = []
    jbatch = jtr.dataset.batch

    def spy(rng, idx, *a):
        seen.append((idx.copy(), jbatch(rng, idx, *a)))
        return seen[-1][1]

    jtr.dataset = dataclasses.replace(ds)
    monkeypatch.setattr(jtr.dataset, "batch", spy)
    # the JAX step is not under test here: return its inputs unchanged
    jtr._step = lambda p, o, e, k, *a: (p, o, e, k, jnp.zeros(()))
    jtr.run(steps=3, progress=False)
    for idx, want in seen:
        got = tr.sample_batch()
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
    assert len(seen) == 3
    assert tr.rng.bit_generator.state == jtr.rng.bit_generator.state


def test_augment_with_given_draws():
    """augment against the JAX trainer's augment (trainer.py:119-134) on
    the same shifts and gains: a per-window wrap-roll over (H, W), then
    contrast and brightness about each frame's channel means."""
    rng = np.random.default_rng(5)
    images = rng.uniform(size=(3, 2, 12, 10, 3)).astype(np.float32)
    shifts = rng.integers(-4, 5, (3, 2)).astype(np.int32)
    bright = (1 + 0.2 * rng.uniform(-1, 1, (3, 1, 1, 1, 1))).astype(np.float32)
    contr = (1 + 0.2 * rng.uniform(-1, 1, (3, 1, 1, 1, 1))).astype(np.float32)
    imgs = jax.vmap(lambda im, s: jnp.roll(im, (s[0], s[1]), axis=(1, 2)))(
        jnp.asarray(images), jnp.asarray(shifts))
    mean = jnp.mean(imgs, axis=(2, 3), keepdims=True)
    want = np.asarray(jnp.clip((imgs - mean) * contr + mean * bright, 0.0, 1.0))
    got = trainer.augment(_t(images), _t(shifts).long(), _t(bright),
                          _t(contr)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert not np.allclose(got, images)


def test_timestep_grid_and_sampling_match_jax():
    # every grid of the default T = 100, as sample_actions computes it
    # (one jit for the 100 shapes: the same values as 100 eager calls)
    grids = jax.jit(lambda: [jnp.linspace(99, 0, n).round().astype(jnp.int32)
                             for n in range(1, 101)])()
    for n, want in zip(range(1, 101), grids):
        assert diffusion.timestep_grid(100, n) == np.asarray(want).tolist(), n
    jcfg, tcfg = _cfgs(False)
    jm, params, tm = _models(jcfg, tcfg)
    img, st, _, _ = _inputs(jcfg, b=2, seed=6)
    sched = diffusion.NoiseSchedule.make(tcfg, "cpu")
    for n_steps in (5, 20):
        key = jax.random.PRNGKey(n_steps)
        want = np.asarray(jdiff.sample_actions(
            jm, params, jdiff.NoiseSchedule.make(jcfg), img, st, key,
            n_steps=n_steps))
        _, sub = jax.random.split(key)      # sample_actions' own draw
        x_T = np.asarray(jax.random.normal(sub, (2, jcfg.horizon,
                                                 jcfg.action_dim)))
        got = diffusion.sample_actions(tm, sched, _t(img), _t(st), _t(x_T),
                                       n_steps=n_steps).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4)


def _scripted(horizon, dof, seen=None):
    """A scripted policy: the newest state plus a ramp of 0.2 steps; the
    observations it is given are appended to `seen`."""
    def policy_fn(images, states):
        if seen is not None:
            seen.append(images.copy())
        ks = 0.2 * (1 + np.arange(horizon, dtype=np.float32))[:, None]
        return (states[0, -1][None] + ks * np.ones((1, dof), np.float32))[None]
    return policy_fn


@pytest.mark.parametrize("ensemble", [False, True],
                         ids=["receding", "ensemble"])
def test_action_chunker_matches_jax(ensemble):
    kw = dict(obs_horizon=2, horizon=6, replan_every=4, ensemble=ensemble,
              ensemble_alpha=0.3)
    seen, jseen = [], []
    got_c = ActionChunker(_scripted(6, 2, seen), **kw)
    want_c = JChunker(_scripted(6, 2, jseen), **kw)
    rng = np.random.default_rng(8)
    for t in range(11):
        img = rng.uniform(size=(4, 4, 3)).astype(np.float32)
        st = rng.normal(size=(2,)).astype(np.float32)
        np.testing.assert_array_equal(got_c.step(img, st),
                                      want_c.step(img, st))
    assert got_c.n_inferences == want_c.n_inferences == (11 if ensemble else 3)
    for a, b in zip(seen, jseen, strict=True):    # the stacked observations
        np.testing.assert_array_equal(a, b)
    assert seen[0].shape == (1, 2, 4, 4, 3)


@pytest.fixture(scope="module")
def closed_loop_scene(tmp_path_factory):
    """tests/test_policy.py::test_closed_loop_eval's scene: the box with a
    hinged lid, 20 random splats, one 32x32 camera."""
    from robosimgs_tpu.utils.meshio import save_mesh
    d = tmp_path_factory.mktemp("closed_loop")
    save_mesh(str(d / "body.glb"), box_mesh())
    save_mesh(str(d / "lid.glb"), box_mesh((0.5, 0.5, 0.05)))
    (d / "robot.urdf").write_text(BOX_URDF)
    jbg = JGaussians.random(jax.random.PRNGKey(0), 20, sh_degree=1, extent=2.0)
    jcams = [JCamera.look_at([3, 0.5, 1.5], [0, 0, 0], [0, 0, 1], 60.0, 32,
                             32)]
    return str(d / "robot.urdf"), jbg, jcams


@pytest.mark.parametrize("chunked", [False, True], ids=["policy_fn", "chunker"])
def test_run_closed_loop_matches_jax(closed_loop_scene, chunked):
    urdf, jbg, jcams = closed_loop_scene
    bg = gaussians_from_numpy(jax.device_get(jbg), "cpu")
    cams = [camera_from_numpy(jax.device_get(c), "cpu") for c in jcams]
    kw = dict(steps=6, obs_horizon=2, actions_per_step=2,
              target_q=np.array([1.2]), image_size=24)
    seen, jseen = [], []
    fn, jfn = _scripted(8, 1, seen), _scripted(8, 1, jseen)
    if chunked:
        chunk = dict(obs_horizon=2, horizon=8, ensemble=True,
                     ensemble_alpha=0.3)
        kw_t = dict(kw, chunker=ActionChunker(fn, **chunk))
        kw_j = dict(kw, chunker=JChunker(jfn, **chunk))
    else:
        kw_j = kw_t = kw
    want = jclosed_loop(jfn, jbg, JObject.from_urdf(urdf), jcams,
                        cfg=JConfig(tile_capacity=128), **kw_j)
    got = run_closed_loop(fn, bg, ArticulatedObject.from_urdf(urdf), cams,
                          cfg=RenderConfig(tile_capacity=128), device="cpu",
                          **kw_t)
    np.testing.assert_array_equal(got.joint_history, want.joint_history)
    np.testing.assert_array_equal(got.action_history, want.action_history)
    assert got.final_error == want.final_error
    assert got.frames.shape == want.frames.shape == (6, 1, 32, 32, 3)
    off = (np.abs(got.frames - want.frames) > 1e-5).any(-1)
    assert off.mean() <= EDGE_FRAC, int(off.sum())
    assert (np.diff(got.joint_history[:, 0]) >= -1e-6).all()
    assert got.joint_history[-1, 0] > got.joint_history[0, 0]
    # the observations: each frame quantized to uint8 by truncation, then
    # resized 32 -> 24 by Pillow's BICUBIC (JAX) or resize_bicubic (port,
    # held against Pillow in test_resize_matches_pillow); the policy's
    # newest observation at step t is frame t - 1 (t = 0: the first
    # render, which the result does not keep)
    from PIL import Image
    steps = list(range(6)) if chunked else [0, 2, 4]
    assert len(seen) == len(jseen) == len(steps)
    for t, a, b in zip(steps[1:], seen[1:], jseen[1:]):
        q, jq = ((np.clip(f[t - 1, 0], 0, 1) * 255).astype(np.uint8)
                 for f in (got.frames, want.frames))
        np.testing.assert_array_equal(
            a[0, -1], resize_bicubic(q, 24, 24).astype(np.float32) / 255.0)
        np.testing.assert_array_equal(
            b[0, -1], np.asarray(Image.fromarray(jq).resize((24, 24)),
                                 np.float32) / 255.0)


def test_entry_points_default_to_cuda():
    """PolicyTrainer, run_closed_loop and the CLI run on the card unless
    asked for the CPU; without a card the trainer raises (no CPU
    fallback)."""
    assert inspect.signature(run_closed_loop).parameters["device"].default \
        == "cuda"
    assert inspect.signature(trainer.PolicyTrainer).parameters[
        "device"].default == "cuda"
    assert cli_policy.build_parser().parse_args(
        ["--frames", "f", "--trajectory", "t", "--output", "o"]).device \
        == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            trainer.PolicyTrainer(trainer.PolicyTrainConfig(policy=SMALL),
                                  toy_dataset(n_eps=1))


@pytest.mark.parametrize("shape", [((480, 640), (96, 96)), ((32, 32), (24, 24))],
                         ids=["640x480_to_96", "32_to_24"])
def test_resize_matches_pillow(shape):
    from PIL import Image
    (h, w), (oh, ow) = shape
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([127 + 120 * np.sin(xx / 7.0 + yy / 11.0),
                       xx * 255.0 / w, yy * 255.0 / h], -1).astype(np.uint8)
    for img in (rng.integers(0, 256, (h, w, 3), dtype=np.uint8), smooth):
        want = np.asarray(Image.fromarray(img).resize((ow, oh))).astype(int)
        got = resize_bicubic(img, ow, oh).astype(int)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1
        assert (got == want).mean() >= 0.99


def test_read_png_rgb(tmp_path):
    from PIL import Image

    from robosimgs_tpu_torch.cli.render import write_png
    img = np.random.default_rng(10).integers(0, 256, (7, 5, 3), dtype=np.uint8)
    write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(read_png_rgb(str(tmp_path / "a.png")), img)
    np.testing.assert_array_equal(
        np.asarray(Image.open(str(tmp_path / "a.png"))), img)
    # Pillow-written RGBA (filtered rows) reads as convert("RGB") gives it;
    # 16-bit PNGs raise (tests/test_torch_png.py has every kind)
    Image.fromarray(img).convert("RGBA").save(str(tmp_path / "b.png"))
    np.testing.assert_array_equal(read_png_rgb(str(tmp_path / "b.png")), img)
    Image.fromarray(img[..., 0].astype(np.uint16) * 257).save(
        str(tmp_path / "c.png"))
    with pytest.raises(ValueError, match="8-bit"):
        read_png_rgb(str(tmp_path / "c.png"))


def test_policy_learns_toy_task():
    """tests/test_policy.py::test_policy_learns_toy_task on the port, at
    its thresholds: training must beat the untrained policy by a wide
    margin at predicting the (state-determined) actions."""
    ds = toy_dataset()
    cfg = trainer.PolicyTrainConfig(policy=SMALL, lr=3e-3, warmup_steps=10,
                                    total_steps=300, batch_size=32,
                                    ema_decay=0.9)
    tr = trainer.PolicyTrainer(cfg, ds, seed=0, device="cpu")
    obs_img = ds.images[:4][:, None]
    obs_state = ds.states[:4][:, None]
    target = 0.8 * ds.states[:4]
    before = tr.predict(obs_img, obs_state, n_steps=10)
    err_before = np.abs(before[:, 0] - target).mean()
    tr.run(steps=300, log_every=100, progress=False)
    after = tr.predict(obs_img, obs_state, n_steps=10)
    err_after = np.abs(after[:, 0] - target).mean()
    assert err_after < err_before * 0.5, (err_before, err_after)
    assert err_after < 0.25, err_after
    assert tr.history[-1]["loss"] < tr.history[0]["loss"]


def test_cli_train_policy_cpu(tmp_path):
    """cli.train_policy on frames written by the port's cli.render_rollout:
    policy.pt loads with weights_only and predicts; the summary has the
    JAX CLI's keys."""
    from robosimgs_tpu_torch.cli import render_rollout as cli_rollout
    from robosimgs_tpu_torch.core.types import Gaussians
    from robosimgs_tpu_torch.scenegen.rollout import open_close_trajectory
    from robosimgs_tpu_torch.train.io_ply import save_ply
    from robosimgs_tpu_torch.utils.meshio import Mesh, save_mesh

    def save_box(path, size):
        m = box_mesh(size)
        save_mesh(path, Mesh(vertices=m.vertices, faces=m.faces))

    save_box(str(tmp_path / "body.glb"), (0.5, 0.5, 0.2))
    save_box(str(tmp_path / "lid.glb"), (0.5, 0.5, 0.05))
    urdf = tmp_path / "robot.urdf"
    urdf.write_text(BOX_URDF)
    scene = str(tmp_path / "scene.ply")
    save_ply(scene, Gaussians.random(torch.Generator().manual_seed(0), 60,
                                     sh_degree=1, extent=2.0, device="cpu"))
    frames = tmp_path / "frames"
    cli_rollout.main(["--scene", scene, "--urdf", str(urdf), "--steps", "8",
                      "--n-cameras", "1", "--width", "40", "--height", "30",
                      "--device", "cpu", "--output", str(frames)])
    traj = str(tmp_path / "traj.npy")
    np.save(traj, open_close_trajectory(
        ArticulatedObject.from_urdf(str(urdf)).model, 8))
    out = tmp_path / "policy"
    cli_policy.main(["--frames", str(frames), "--trajectory", traj,
                     "--output", str(out), "--steps", "3", "--batch-size",
                     "4", "--horizon", "4", "--image-size", "24",
                     "--device", "cpu"])
    with open(out / "train_summary.json") as fh:
        summary = json.load(fh)
    assert set(summary) == {"history", "episodes", "transitions"}
    assert summary["episodes"] == 1 and summary["transitions"] == 8
    model, norm, cfg = trainer.load_policy(str(out / "policy.pt"), "cpu")
    assert cfg.policy.image_size == (24, 24) and cfg.policy.action_dim == 1
    imgs, _ = cli_policy.load_episode(str(frames), traj, 0, 24)
    assert imgs.shape == (8, 24, 24, 3) and imgs.std() > 0.01
    acts = trainer.predict_actions(
        model, diffusion.NoiseSchedule.make(cfg.policy, "cpu"), norm,
        imgs[None, :2], np.zeros((1, 2, 1), np.float32),
        torch.Generator().manual_seed(0), n_steps=4)
    assert acts.shape == (1, 4, 1) and np.isfinite(acts).all()
