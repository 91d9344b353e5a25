"""The ring-streamed Gaussian set (parallel/ring.py) on 4 spawned gloo
ranks on the CPU (one spawn for the module) against the JAX package's
ring_bin_gather (tests/test_ring.py's shard_map wrapper) on
jax.devices()[:4], and against binning the whole set: counts bit-equal,
geom / feat atol 1e-5 / rtol 1e-4 on the valid slots, radii / valid as
tests/test_ring.py holds them; the ring step against the all_gather step
(loss rtol 1e-6, gradients atol 2e-6) and against JAX's ring step; the
"normal" output; the collectives the ring step makes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosimgs_tpu.parallel.mesh import make_mesh as jmake_mesh
from robosimgs_tpu.train.optim import float_params as jfloat_params
from tests.test_dist import setup
from tests.test_ring import _ring_fn, _setup

from robosimgs_tpu_torch.core.convert import (camera_from_numpy,
                                              gaussians_from_numpy,
                                              shard_train_state_from_numpy)
from robosimgs_tpu_torch.parallel.ring import crop_camera_rows
from robosimgs_tpu_torch.render.binning import bin_and_gather_packed
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.project import project
from robosimgs_tpu_torch.render.rasterize import rasterize
from robosimgs_tpu_torch.tools import dist_run
from robosimgs_tpu_torch.train.trainer import TrainConfig

WORLD = 4
RING_MESHES = [(4, 1), (2, 2)]
RCFG = RenderConfig(tile_capacity=128, ref_gaussian_chunk=64)
CFG = TrainConfig(render=RCFG, scene_extent=1.0, impl="reference")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def scene():
    jcfg, jcam, jg = _setup(n=64)
    _, frames, targets, state, _ = setup(n_cams=1)
    return dict(jcfg=jcfg, jcam=jcam, jg=jg, frames=frames,
                target=targets[0], state=state)


def _gaussian_shards(g, n):
    """Gaussians (CPU) of each of n contiguous shards."""
    local = g.capacity // n
    return [g.replace(**{f.name: getattr(g, f.name)[r * local:(r + 1) * local]
                         for f in dataclasses.fields(g)}) for r in range(n)]


@pytest.fixture(scope="module")
def results(scene):
    g = gaussians_from_numpy(jax.device_get(scene["jg"]), "cpu")
    cam = camera_from_numpy(jax.device_get(scene["jcam"]), "cpu")
    cases = [(f"ring{shape}", dist_run.ring, dict(
        mesh_shape=shape, cfg=RCFG, shards=_gaussian_shards(g, shape[0]),
        camera=cam, background=np.zeros(3, np.float32)))
        for shape in RING_MESHES]
    cases.append(("normals", dist_run.ring, dict(
        mesh_shape=(2, 2), cfg=dataclasses.replace(RCFG, render_normals=True),
        shards=_gaussian_shards(g, 2), camera=cam,
        background=np.zeros(3, np.float32))))
    state = _np(scene["state"])
    tcam = camera_from_numpy(jax.device_get(scene["frames"][0].camera), "cpu")
    for gather in ("all_gather", "ring"):
        cases.append((gather, dist_run.gs_step, dict(
            mesh_shape=(2, 2), cfg=CFG, impl="tiled", gather=gather,
            shards=[shard_train_state_from_numpy(state, 2, r, "cpu")
                    for r in range(2)],
            camera=tcam, target=np.asarray(scene["target"]))))
    return dist_run.run_ranks(dist_run.run_cases, WORLD, args=(cases,))


def _whole_set(scene, n_tile):
    """The port's binning of the whole set, per row strip."""
    g = gaussians_from_numpy(jax.device_get(scene["jg"]), "cpu")
    cam = camera_from_numpy(jax.device_get(scene["jcam"]), "cpu")
    rows = cam.height // n_tile
    out = []
    for t in range(n_tile):
        crop = crop_camera_rows(cam, t * rows, rows)
        proj = project(g, crop, RCFG, means2d_offset=torch.zeros((64, 2)),
                       tan_half_fov=cam.tan_half_fov)
        out.append(bin_and_gather_packed(proj, cam.width, rows, RCFG)[:3])
    return out


@pytest.mark.parametrize("mesh_shape", RING_MESHES)
def test_ring_bin_gather_matches_jax_and_whole_set(scene, results,
                                                   mesh_shape):
    n_shard, n_tile = mesh_shape
    jg, jcam = scene["jg"], scene["jcam"]
    fn = _ring_fn(jmake_mesh(n_shard, n_tile, devices=jax.devices()[:WORLD]),
                  jcam, scene["jcfg"], n_shard, n_tile)
    jgeom, jfeat, jcounts, jradii, jvalid = [
        np.asarray(x) for x in fn(jfloat_params(jg), jg.alive,
                                  jnp.zeros((64, 2), jnp.float32))]
    T = jcounts.shape[0] // n_tile
    nc = 64 // n_shard
    whole = _whole_set(scene, n_tile)
    for rank, res in enumerate(results):
        got = res[f"ring{mesh_shape}"]
        d, t = divmod(rank, n_tile)
        counts = jcounts[t * T:(t + 1) * T]
        np.testing.assert_array_equal(got["counts"], counts)
        np.testing.assert_array_equal(got["counts"], whole[t][2].numpy())
        st = got["stats"]
        assert int(st["truncated_gaussians"]) == 0
        assert int(st["overflowed_tiles"]) == 0
        kmask = np.arange(RCFG.tile_capacity)[None, None, :] \
            < counts[:, None, None]
        for name, a, b, c in (("geom", got["geom"], jgeom, whole[t][0]),
                              ("feat", got["feat"], jfeat, whole[t][1])):
            for want in (b[t * T:(t + 1) * T], c.numpy()):
                np.testing.assert_allclose(np.where(kmask, a, 0.0),
                                           np.where(kmask, want, 0.0),
                                           atol=1e-5, rtol=1e-4,
                                           err_msg=name)
        # the hop-0 side channel: JAX lays it out tile-major, data-minor
        j = (t * n_shard + d) * nc
        np.testing.assert_allclose(got["radii"], jradii[j:j + nc],
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(got["valid"], jvalid[j:j + nc])


def test_ring_step_matches_all_gather_step(results):
    for res in results:
        want, got = res["all_gather"], res["ring"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=1e-6)
        assert int(got["n_alive"]) == int(want["n_alive"]) == 40
        assert int(got["step"]) == 1
        for k, w in want["grads"].items():
            np.testing.assert_allclose(got["grads"][k], w, atol=2e-6,
                                       err_msg=k)
        for k in ("grad_accum", "count", "max_radii"):
            np.testing.assert_allclose(got["densify"][k],
                                       want["densify"][k], atol=2e-6,
                                       err_msg=k)


def test_ring_step_matches_jax(scene, results):
    """The ring step (tiled: the kernels' plain versions) against the
    JAX package's (Pallas in interpret mode) at (2, 2): loss rtol 1e-5,
    each shard's gradient rows atol 2e-6 (tests/test_dist.py's)."""
    from robosimgs_tpu.parallel.distributed import \
        make_gaussian_sharded_train_step
    jcfg, _, _, _, _ = setup(n_cams=1)
    step = make_gaussian_sharded_train_step(
        jcfg, jmake_mesh(2, 2, devices=jax.devices()[:WORLD]), impl="tiled",
        return_grads=True, gather="ring")
    state = jax.tree_util.tree_map(
        lambda x: jnp.copy(x) if isinstance(x, jax.Array) else x,
        scene["state"])
    _, want = step(state, scene["frames"][0].camera,
                   jnp.asarray(scene["target"]))
    for res in results:
        np.testing.assert_allclose(res["ring"]["loss"], float(want["loss"]),
                                   rtol=1e-5)
    for k, w in want["grads"].items():
        got = np.concatenate([results[r]["ring"]["grads"][k] for r in (0, 2)])
        np.testing.assert_allclose(got, np.asarray(w), atol=2e-6, err_msg=k)


def test_ring_step_rotates_and_gathers_no_gaussians(scene, results):
    """The port's counterpart of test_ring_lowering_has_no_all_gather:
    the ring step's only all_gather is the tile axis's gather of the
    rendered strips (its transpose the one reduce-scatter); the Gaussian
    set moves by rotations only: n - 1 hops forward, n - 1 backward and
    one home. The all_gather step gathers the projection besides."""
    H, W = scene["target"].shape[:2]
    strip = (H // 2) * W * 3 * 4
    for res in results:
        calls, nbytes = res["ring"]["comm_calls"], res["ring"]["comm_bytes"]
        assert calls["rotate"] == 3
        assert calls["all_gather"] == 1 and nbytes["all_gather"] == strip
        assert calls["reduce_scatter"] == 1
        ag = res["all_gather"]["comm_calls"]
        assert ag["all_gather"] == 2 and "rotate" not in ag


def test_ring_render_rows_emits_normals(scene, results):
    """cfg.render_normals survives the ring: the strips' "normal" and
    "rgb" maps assembled equal the single-device tiled render's (the
    port's; tests/test_torch_render.py holds it against JAX's)."""
    g = gaussians_from_numpy(jax.device_get(scene["jg"]), "cpu")
    cam = camera_from_numpy(jax.device_get(scene["jcam"]), "cpu")
    ref = rasterize(g, cam, dataclasses.replace(RCFG, render_normals=True),
                    impl="tiled")
    for d in range(2):
        strips = [results[d * 2 + t]["normals"] for t in range(2)]
        normal = np.concatenate([s["normal"] for s in strips])
        rgb = np.concatenate([s["rgb"] for s in strips])
        assert normal.shape == (cam.height, cam.width, 3)
        np.testing.assert_allclose(rgb, ref["rgb"].numpy(), atol=1e-5,
                                   rtol=1e-4)
        np.testing.assert_allclose(normal, ref["normal"].numpy(), atol=1e-4,
                                   rtol=1e-3)
