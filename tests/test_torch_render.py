"""End-to-end render parity: the port's rasterize / composite_tiled on CPU
tensors against the JAX package's tiled path (Pallas kernel in interpret
mode) and its reference compositor; PLY interchange; the render CLI."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosimgs_tpu.core.camera import Camera as JCamera
from robosimgs_tpu.core.types import Gaussians as JGaussians
from robosimgs_tpu.render.config import RenderConfig as JConfig
from robosimgs_tpu.render.project import project as jproject
from robosimgs_tpu.render.reference import composite_reference as jreference
from robosimgs_tpu.render.tiled import composite_tiled as jtiled
from robosimgs_tpu.train import io_ply as jio

from robosimgs_tpu_torch.cli import render as cli_render
from robosimgs_tpu_torch.core.convert import (camera_from_numpy,
                                              gaussians_from_numpy)
from robosimgs_tpu_torch.render import rasterize
from robosimgs_tpu_torch.render.binning import bin_and_gather_packed
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.gathered import composite_gathered, untile
from robosimgs_tpu_torch.render.project import project
from robosimgs_tpu_torch.render.tiled import composite_tiled
from robosimgs_tpu_torch.render.tiles import num_tiles
from robosimgs_tpu_torch.train.io_ply import load_ply, save_ply

KW = dict(tile_capacity=256, max_tiles_per_gaussian=64, ref_gaussian_chunk=64)
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(jg, jcam):
    return (gaussians_from_numpy(jax.device_get(jg), "cpu"),
            camera_from_numpy(jax.device_get(jcam), "cpu"))


def _close(out, want, keys=("rgb", "alpha", "depth")):
    for k in keys:
        w = np.asarray(want[k])
        assert out[k].shape == w.shape, k
        np.testing.assert_allclose(out[k].numpy(), w, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("wh", [(64, 48), (37, 23)])
def test_rasterize_tiled_matches_jax(wh):
    w, h = wh
    jg = JGaussians.random(jax.random.PRNGKey(4), 150, sh_degree=1)
    jcam = JCamera.look_at([4.0, 0.3, 0.8], [0, 0, 0], [0, 0, 1], 60.0, w, h)
    jcfg = JConfig(**KW)
    jp = jproject(jg, jcam, jcfg)
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    want_p = jtiled(jp, w, h, jcfg, background=jnp.asarray(bg),
                    compositor="pallas")
    want_r = jreference(jp, w, h, jcfg, background=jnp.asarray(bg))
    g, cam = _port(jg, jcam)
    out = rasterize(g, cam, RenderConfig(**KW), background=torch.from_numpy(bg),
                    impl="tiled")
    ref = rasterize(g, cam, RenderConfig(**KW), background=torch.from_numpy(bg))
    # the plain gathered compositor on the port's binned blocks, against
    # the JAX package's gathered ("jnp") path
    cfg = RenderConfig(**KW)
    tiles_x, tiles_y = num_tiles(w, h, cfg.tile_size)
    geom, feat, counts, _ = bin_and_gather_packed(project(g, cam, cfg), w, h, cfg)
    img = untile(composite_gathered(geom, feat, counts, tiles_x, cfg),
                 tiles_x, tiles_y, w, h, cfg.tile_size)
    gathered = {"rgb": img[..., :3] + (1.0 - img[..., 4:5]) * torch.from_numpy(bg),
                "alpha": img[..., 4], "depth": img[..., 3]}
    _close(out, want_p)
    _close(out, want_r)
    _close(ref, want_r)
    _close(gathered, jtiled(jp, w, h, jcfg, background=jnp.asarray(bg),
                            compositor="jnp"))
    assert float(out["alpha"].max()) > 0.5


def test_empty_scene_and_camera_facing_away():
    jg = JGaussians.random(jax.random.PRNGKey(5), 80, sh_degree=1)
    g, _ = _port(jg, JCamera.look_at([4, 0, 0], [0, 0, 0], [0, 0, 1], 60.0,
                                     32, 32))
    cfg = RenderConfig(**KW)
    away = camera_from_numpy(jax.device_get(JCamera.look_at(
        [4.0, 0.3, 0.8], [8.0, 0.6, 1.6], [0, 0, 1], 60.0, 40, 24)), "cpu")
    out = rasterize(g, away, cfg, impl="tiled")
    assert float(out["alpha"].abs().max()) == 0.0
    toward = camera_from_numpy(jax.device_get(JCamera.look_at(
        [4.0, 0.3, 0.8], [0, 0, 0], [0, 0, 1], 60.0, 40, 24)), "cpu")
    dead = g.replace(alive=torch.zeros_like(g.alive))
    bg = torch.tensor([0.1, 0.2, 0.3])
    out = rasterize(dead, toward, cfg, background=bg, impl="tiled")
    assert float(out["alpha"].abs().max()) == 0.0
    np.testing.assert_allclose(out["rgb"].numpy(),
                               np.broadcast_to(bg.numpy(), (24, 40, 3)))


def test_normal_map_matches_jax():
    rng = np.random.default_rng(0)
    xy = rng.uniform(-0.8, 0.8, (64, 2)).astype(np.float32)
    means = np.concatenate([xy, np.zeros((64, 1), np.float32)], 1)
    jg = JGaussians.from_points(means, colors=np.full((64, 3), 0.6, np.float32),
                                init_scale=np.full((64,), 0.25, np.float32))
    ls = np.array(jg.log_scales)
    ls[:, 2] = np.log(1e-3)
    jg = jg.replace(log_scales=jnp.asarray(ls))
    jcam = JCamera.look_at([2.0, 0, 2.5], [0, 0, 0], [0, 1, 0], 60.0, 48, 32)
    jcfg = JConfig(render_normals=True, tile_capacity=256)
    want = jtiled(jproject(jg, jcam, jcfg), 48, 32, jcfg)
    g, cam = _port(jg, jcam)
    cfg = RenderConfig(render_normals=True, tile_capacity=256)
    out = composite_tiled(project(g, cam, cfg), 48, 32, cfg)
    _close(out, want, keys=("rgb", "alpha", "depth", "normal"))
    assert float(out["alpha"].max()) > 0.5


def test_ply_round_trip_with_jax(tmp_path):
    jg = JGaussians.random(jax.random.PRNGKey(6), 30, sh_degree=2, capacity=36)
    g, _ = _port(jg, JCamera.look_at([4, 0, 0], [0, 0, 0], [0, 0, 1], 60.0,
                                     8, 8))
    ours, theirs = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    save_ply(ours, g)
    jio.save_ply(theirs, jg)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    back = load_ply(theirs, capacity=40, device="cpu")
    jback = jax.device_get(jio.load_ply(ours, capacity=40))
    for name in ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
                 "sh_rest", "alive"):
        np.testing.assert_array_equal(getattr(back, name).numpy(),
                                      np.asarray(getattr(jback, name)))


def test_cli_render_cpu(tmp_path):
    jg = JGaussians.random(jax.random.PRNGKey(7), 120, sh_degree=1)
    scene = str(tmp_path / "scene.ply")
    jio.save_ply(scene, jg)
    out_dir = tmp_path / "views"
    cli_render.main([scene, "--output", str(out_dir), "--orbit", "2",
                     "--width", "40", "--height", "32", "--device", "cpu",
                     "--impl", "tiled", "--background", "0", "0", "0"])
    from PIL import Image
    for i in range(2):
        img = np.asarray(Image.open(out_dir / f"orbit_{i:04d}.png"))
        assert img.shape == (32, 40, 3) and img.max() > 0
    # --transforms: the cameras of a transforms.json (OpenGL c2w at
    # y = -4 looking along +y at the scene)
    c2w = np.eye(4)
    c2w[:3, :3] = [[1, 0, 0], [0, 0, -1], [0, 1, 0]]
    c2w[:3, 3] = [0.0, -4.0, 0.3]
    (tmp_path / "transforms.json").write_text(json.dumps({
        "fl_x": 35.0, "fl_y": 35.0, "cx": 20.0, "cy": 16.0, "w": 40, "h": 32,
        "frames": [{"transform_matrix": c2w.tolist()}]}))
    cli_render.main([scene, "--output", str(out_dir), "--transforms",
                     str(tmp_path / "transforms.json"), "--device", "cpu",
                     "--background", "0", "0", "0"])
    img = np.asarray(Image.open(out_dir / "view_0000.png"))
    assert img.shape == (32, 40, 3) and img.max() > 0
    with pytest.raises(SystemExit, match="required"):
        cli_render.main([scene, "--output", str(out_dir), "--device", "cpu"])


def test_cli_render_reports_truncation(tmp_path, capsys):
    """5,000 splats over a 32x32 orbit view (4 tiles) want more than the
    default tile capacity of 1024: the CLI names the dropped splats and the
    remedy on stderr, from the render's own BinStats, and writes the same
    pixels as the in-process render."""
    jg = JGaussians.random(jax.random.PRNGKey(3), 5000, sh_degree=0)
    scene = str(tmp_path / "scene.ply")
    jio.save_ply(scene, jg)
    out = tmp_path / "view.png"
    argv = [scene, "--output", str(out), "--orbit", "1", "--width", "32",
            "--height", "32", "--device", "cpu", "--impl", "tiled"]
    cli_render.main(argv)
    err = capsys.readouterr().err
    g = load_ply(scene, device="cpu")
    cam = cli_render.orbit_cameras(g, 1, 60.0, 32, 32, device="cpu")[0]
    with torch.no_grad():
        ref = rasterize(g, cam, background=torch.ones(3), impl="tiled",
                        return_stats=True)
    st = ref["stats"]
    assert int(st.overflowed_tiles) > 0
    assert (f"{int(st.truncated_gaussians)} truncated gaussians, "
            f"{int(st.overflowed_tiles)} overflowed tiles") in err
    assert "recommend_capacities" in err
    from robosimgs_tpu_torch.utils.imresize import read_png_rgb
    np.testing.assert_array_equal(
        read_png_rgb(str(out)),
        (np.clip(ref["rgb"].numpy(), 0, 1) * 255).astype(np.uint8))
    # the reference compositor bins nothing: no stats, nothing to report
    cli_render.main(argv[:-2] + ["--impl", "reference"])
    assert capsys.readouterr().err == ""
