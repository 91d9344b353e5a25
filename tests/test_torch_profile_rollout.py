"""tools/profile_rollout.py and tools/rollout_gate384.py against the JAX
package's scripts/profile_rollout.py and scripts/rollout_gate384.py on
the CPU.

The script's configs come from a function nested in its main() (mkcfg)
and a loop over RSGS_ROLLOUT_VARIANTS, which cannot be imported: the
RenderConfigs they build are written out here and held field by field
against the tool's. The gate renders run on the script's own draw
(jax.random key 2, carried across by core/convert.py) at 2,000
Gaussians and 64x48: every gate K's rgb against JAX composite_tiled's
(Pallas in interpret mode, jitted) within 1e-5, and equal truncation
counts. PSNR near saturation is a ratio of tiny errors and is not
compared across the packages. Then each tool's main() on the CPU at a
small size prints its line with the script's keys."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from robosimgs_tpu.core.camera import Camera as JCamera
from robosimgs_tpu.core.types import Gaussians as JGaussians
from robosimgs_tpu.render.config import RenderConfig as JRenderConfig
from robosimgs_tpu.render.project import project as jproject
from robosimgs_tpu.render.tiled import composite_tiled as jcomposite_tiled

from robosimgs_tpu_torch.core.convert import (camera_from_numpy,
                                              gaussians_from_numpy)
from robosimgs_tpu_torch.tools import profile_rollout as pr
from robosimgs_tpu_torch.tools import rollout_gate384

N, W, H = 2000, 64, 48
SPEC = ("tt12_K512,k=512,m=64,bbox=84,split=12,frac=0.44864;"
        "K384,k=384,m=64,bbox=84;bare")
# what the script's mkcfg and its spec loop build for SPEC
SCRIPT_VARIANTS = {
    "r4_single_K1024": JRenderConfig(
        tile_capacity=1024, tile_chunk=512, max_tiles_per_gaussian=12,
        bbox_tiles_per_gaussian=0, two_tier_split=0, two_tier_spill_frac=0.0),
    "tt12_K512": JRenderConfig(
        tile_capacity=512, tile_chunk=512, max_tiles_per_gaussian=64,
        bbox_tiles_per_gaussian=84, two_tier_split=12,
        two_tier_spill_frac=0.44864),
    "K384": JRenderConfig(
        tile_capacity=384, tile_chunk=0, max_tiles_per_gaussian=64,
        bbox_tiles_per_gaussian=84, two_tier_split=0,
        two_tier_spill_frac=0.0),
    "bare": JRenderConfig(
        tile_capacity=1024, tile_chunk=512, max_tiles_per_gaussian=12,
        bbox_tiles_per_gaussian=0, two_tier_split=0, two_tier_spill_frac=0.0),
}
# the script's gate: candidates and the lossless reference at M 64 over an
# 84-tile bbox, mkcfg's chunk rule and one tier; rollout_gate384's K 384
# at chunk 0 and its reference, RenderConfig's other defaults
SCRIPT_GATE = {k: JRenderConfig(
    tile_capacity=k, tile_chunk=512 if k % 512 == 0 else 0,
    max_tiles_per_gaussian=64, bbox_tiles_per_gaussian=84, two_tier_split=0,
    two_tier_spill_frac=0.0) for k in (8192, 2048, 1024, 512)}
GATE384 = {k: JRenderConfig(tile_capacity=k, tile_chunk=chunk,
                            max_tiles_per_gaussian=64,
                            bbox_tiles_per_gaussian=84)
           for k, chunk in ((384, 0), (8192, 512))}
RESULT_KEYS = {"n", "T", "iters", "project_ms", "project_bin_ms",
               "pallas_fwd_ms", "gate_K2048_dB", "gate_K1024_dB",
               "gate_K512_dB", "r4_lossy_dB"}
FRAME_KEYS = {"one_cam_ms", "seq4_ms", "batched4_ms"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def same_config(port, jax_cfg):
    for f in dataclasses.fields(jax_cfg):
        assert getattr(port, f.name) == getattr(jax_cfg, f.name), f.name


def test_variants_are_the_scripts_configs():
    got = pr.parse_variants(SPEC)
    assert list(got) == list(SCRIPT_VARIANTS)
    for name, want in SCRIPT_VARIANTS.items():
        same_config(got[name], want)
    assert list(pr.parse_variants("")) == ["r4_single_K1024"]


@pytest.fixture(scope="module")
def jax_draw():
    g = JGaussians.random(jax.random.PRNGKey(2), N, sh_degree=2, extent=1.5)
    cam = JCamera.look_at([3.0, 0.4, 1.0], [0, 0, 0], [0, 0, 1], 60.0, W, H)
    return g, cam


@pytest.fixture(scope="module")
def port_draw(jax_draw):
    g, cam = jax_draw
    return (gaussians_from_numpy(jax.device_get(g), "cpu"),
            camera_from_numpy(jax.device_get(cam), "cpu"))


def jax_render(g, cam, cfg):
    out = jax.jit(lambda: jcomposite_tiled(jproject(g, cam, cfg), W, H, cfg,
                                           return_stats=True))()
    return (np.asarray(out["rgb"]),
            int(out["stats"].truncated_gaussians))


def test_gate_renders_match_jax(jax_draw, port_draw):
    got = pr.gate(*port_draw, lossy=pr.mkcfg(1024))
    got384 = rollout_gate384.gate384(*port_draw)
    names = {"K8192": 8192, "K2048": 2048, "K1024": 1024, "K512": 512}
    for name, k in names.items():
        same_config(pr.mkcfg(k, pr.GATE_M, pr.GATE_BBOX,
                             chunk=512 if name == "K8192" else None),
                    SCRIPT_GATE[k])
    runs = [(got, name, SCRIPT_GATE[k]) for name, k in names.items()]
    runs += [(got, "r4", SCRIPT_VARIANTS["r4_single_K1024"]),
             (got384, "K384", GATE384[384]),
             (got384, "K8192", GATE384[8192])]
    for res, name, cfg in runs:
        rgb, trunc = jax_render(*jax_draw, cfg)
        np.testing.assert_allclose(res["rgb"][name].numpy(), rgb, atol=1e-5,
                                   rtol=0, err_msg=name)
        assert res["truncated"][name] == trunc, name
    assert set(got) >= {"gate_K2048_dB", "gate_K1024_dB", "gate_K512_dB",
                        "r4_lossy_dB"}
    assert "gate_K384_dB" in got384


def test_main_prints_the_scripts_keys(capsys):
    assert pr.main(["--device", "cpu", "--n", str(N), "--width", str(W),
                    "--height", str(H), "--iters", "1", "--variants",
                    "tt12_K512,k=512,m=64,bbox=84,split=12,frac=0.5"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert any(line.startswith("cam0 stats: max_count=") for line in lines)
    res = json.loads(lines[-1][len("RESULT "):])
    assert lines[-1].startswith("RESULT ") and RESULT_KEYS <= set(res)
    assert res["n"] == N and res["T"] == 12 and res["iters"] == 1
    for name in ("r4_single_K1024", "tt12_K512"):
        assert FRAME_KEYS <= set(res[name])
        assert all(np.isfinite(res[name][k]) for k in FRAME_KEYS)
        runs = res[name]["batched4_runs_ms"]
        assert len(runs) == 4
        assert res[name]["batched4_ms"] == (runs[0] + runs[3]) / 2
    assert res["device"] == "cpu" and res["timer"] == "host clock"


def test_gate384_prints_the_scripts_line(capsys):
    assert rollout_gate384.main(["--device", "cpu", "--n", str(N),
                                 "--width", str(W), "--height",
                                 str(H)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("GATE K=384 (m=64) vs K=8192: ")
    assert out[0].endswith(" dB")
