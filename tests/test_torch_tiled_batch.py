"""The batched multi-camera composite (render/tiled.py::
composite_tiled_batch) against the JAX package's: two cameras at 64x48
through one composite of their concatenated tiles, with and without a
per-camera depth limit, with its BinStats and the normal map; against
the port's per-camera composite_tiled; the gradient w.r.t. the stacked
projections against jax.grad."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosimgs_tpu.core.camera import Camera as JCamera
from robosimgs_tpu.core.types import Gaussians as JGaussians
from robosimgs_tpu.render.config import RenderConfig as JConfig
from robosimgs_tpu.render.project import project as jproject
from robosimgs_tpu.render.tiled import composite_tiled_batch as jbatch

from robosimgs_tpu_torch.core.convert import projected_from_numpy
from robosimgs_tpu_torch.render import kernels
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.project import Projected
from robosimgs_tpu_torch.render.tiled import (composite_tiled,
                                              composite_tiled_batch,
                                              stack_projected)

W, H = 64, 48
KW = dict(tile_capacity=256, max_tiles_per_gaussian=64, render_normals=True)
# the forward's tolerance (tests/test_torch_render.py): the plain
# compositor sums its blocks in another order than the Pallas kernel
ATOL = 1e-5
EYES = ([4.0, 0.3, 0.8], [-3.0, 2.5, 1.0])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """The JAX projections of two cameras, stacked (the JAX package's
    tree.map), the port's stacked counterpart, and a depth limit per
    camera."""
    jg = JGaussians.random(jax.random.PRNGKey(4), 150, sh_degree=1)
    jcfg = JConfig(**KW)
    jps = [jproject(jg, JCamera.look_at(e, [0, 0, 0], [0, 0, 1], 60.0, W, H),
                    jcfg) for e in EYES]
    jprojs = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jps)
    projs = stack_projected([projected_from_numpy(jax.device_get(p), "cpu")
                             for p in jps])
    dlim = np.random.default_rng(2).uniform(3.0, 5.0, (2, H, W)).astype(
        np.float32)
    return jprojs, projs, dlim


def _close(out, want, keys):
    for k in keys:
        w = np.asarray(want[k])
        assert tuple(out[k].shape) == w.shape, k
        np.testing.assert_allclose(out[k].detach().numpy(), w, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("with_dlim", [False, True], ids=["plain", "dlim"])
def test_batch_matches_jax(scene, with_dlim, monkeypatch):
    """rgb, alpha, depth and the normal map against the JAX package's
    batch (Pallas in interpret mode, and its "jnp" compositor against the
    port's "gathered"), each camera's BinStats equal, one forward launch
    (a call of the wrapper) for both cameras."""
    jprojs, projs, dlim = scene
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    jd = jnp.asarray(dlim) if with_dlim else None
    d = torch.from_numpy(dlim) if with_dlim else None
    want = jbatch(jprojs, W, H, JConfig(**KW), background=jnp.asarray(bg),
                  return_stats=True, depth_limit=jd)
    calls = []
    fwd = kernels.composite_fwd

    def counted(geom, *a, **k):
        calls.append((geom.shape[0], k["n_tiles_per_image"]))
        return fwd(geom, *a, **k)

    monkeypatch.setattr(kernels, "composite_fwd", counted)
    out = composite_tiled_batch(projs, W, H, RenderConfig(**KW),
                                background=torch.from_numpy(bg),
                                return_stats=True, depth_limit=d)
    assert calls == [(2 * 12, 12)]      # 2 cameras x 4 x 3 tiles, one call
    keys = ("rgb", "alpha", "depth", "normal")
    _close(out, want, keys)
    for f in ("truncated_gaussians", "overflowed_tiles", "max_tile_count",
              "total_pairs"):
        np.testing.assert_array_equal(getattr(out["stats"], f).numpy(),
                                      np.asarray(getattr(want["stats"], f)),
                                      err_msg=f)
    gathered = composite_tiled_batch(projs, W, H, RenderConfig(**KW),
                                     background=torch.from_numpy(bg),
                                     compositor="gathered", depth_limit=d)
    _close(gathered, jbatch(jprojs, W, H, JConfig(**KW),
                            background=jnp.asarray(bg), compositor="jnp",
                            depth_limit=jd), keys)
    assert float(out["alpha"].max()) > 0.5
    if with_dlim:   # the limit occludes something
        free = composite_tiled_batch(projs, W, H, RenderConfig(**KW))
        assert float((free["alpha"] - out["alpha"]).abs().max()) > 1e-3


def test_batch_matches_per_camera_composite(scene):
    """Camera c of the batch is composite_tiled of camera c alone,
    bit for bit (the same arithmetic, tile t at the pixels of t % T)."""
    _, projs, dlim = scene
    cfg = RenderConfig(**KW)
    out = composite_tiled_batch(projs, W, H, cfg,
                                depth_limit=torch.from_numpy(dlim))
    for c in range(2):
        one = composite_tiled(
            Projected(**{f.name: None if getattr(projs, f.name) is None
                         else getattr(projs, f.name)[c]
                         for f in dataclasses.fields(Projected)}),
            W, H, cfg, depth_limit=torch.from_numpy(dlim[c]))
        for k in ("rgb", "alpha", "depth", "normal"):
            assert torch.equal(out[k][c], one[k]), k


def test_batch_gradient_matches_jax(scene):
    """d/d projs of a weighted sum of the batch's rgb, alpha and depth,
    against jax.grad of the JAX batch, each field within 1e-4 of its
    largest (the gather's transpose and the compositor sum in other
    orders); each camera's gradient reaches only its own projection."""
    jprojs, projs, dlim = scene
    cfg = RenderConfig(**KW)
    rng = np.random.default_rng(5)
    w_rgb = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    w_a = rng.normal(size=(2, H, W)).astype(np.float32)
    w_d = rng.normal(size=(2, H, W)).astype(np.float32) * 0.1
    fields = ("means2d", "conics", "colors", "opacities", "depths")

    def jloss(sub):
        p = dataclasses.replace(jprojs, **sub)
        out = jbatch(p, W, H, JConfig(**KW), depth_limit=jnp.asarray(dlim))
        return (jnp.sum(out["rgb"] * w_rgb) + jnp.sum(out["alpha"] * w_a)
                + jnp.sum(out["depth"] * w_d))

    jgrads = jax.grad(jloss)({f: getattr(jprojs, f) for f in fields})
    leaves = {f: getattr(projs, f).clone().requires_grad_(True)
              for f in fields}
    p = dataclasses.replace(projs, **leaves)
    out = composite_tiled_batch(p, W, H, cfg,
                                depth_limit=torch.from_numpy(dlim))
    loss = (torch.sum(out["rgb"] * torch.from_numpy(w_rgb))
            + torch.sum(out["alpha"] * torch.from_numpy(w_a))
            + torch.sum(out["depth"] * torch.from_numpy(w_d)))
    loss.backward()
    for f in fields:
        want = np.asarray(jgrads[f])
        got = leaves[f].grad.numpy()
        assert np.abs(want).max() > 0, f
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=f)
    # camera 1's image does not reach camera 0's projection
    only1 = {f: getattr(projs, f).clone().requires_grad_(True)
             for f in fields}
    out = composite_tiled_batch(dataclasses.replace(projs, **only1), W, H,
                                cfg)
    (out["rgb"][1].sum() + out["depth"][1].sum()).backward()
    for f in fields:
        assert float(only1[f].grad[0].abs().max()) == 0.0, f
        assert float(only1[f].grad[1].abs().max()) > 0.0, f
