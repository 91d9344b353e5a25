"""The feature A/B tool (tools/ab_features.py) against the JAX package's
scripts/ab_features.py: the seven arms' TrainConfigs and the initial
points, taken from the script's main() at a small size (its Trainer
replaced by a recorder, its scene by a small build), and one step of
every arm on the CPU through the plain kernels."""

import json
import math
import os
import sys
import time

import jax
import numpy as np
import pytest
import torch

from robosimgs_tpu.train import trainer as jt

from robosimgs_tpu_torch.tools import ab_features

from test_torch_flagship import assert_config_equal, load_script

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
KNOBS = dict(AB_RES=32, AB_ITERS=1500, AB_CAPACITY=4096, AB_VIEWS=4,
             AB_HOLDOUT=1)
ARM_KEYS = {"eval_psnr", "final_loss", "alive", "overflow",
            "median_scale_ratio", "iters_per_sec"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Recorded:
    """Stands in for the JAX Trainer: keeps the arm's config and starting
    pool, trains nothing and reports the starting pool as trained."""

    def __init__(self, seen, cfg, init, train_frames, eval_frames=None):
        seen.append((cfg, init))
        self.cfg = cfg
        self.state = jt.TrainState(gaussians=init, opt_state=None,
                                   densify_state=None, step=0, key=None)
        self.history = [{"loss": 0.0, "overflow": 0}]

    def run(self, progress=True, on_log=None):
        time.sleep(1e-3)     # the script divides the iterations by this

    def eval_psnr(self):
        return 0.0


@pytest.fixture(scope="module")
def jax_arms(tmp_path_factory):
    """[(cfg, init)] of every arm, in the order the script trains them."""
    script = load_script(os.path.join(SCRIPTS, "ab_features.py"),
                         "ab_features_script")
    seen = []
    mp = pytest.MonkeyPatch()
    for k, v in KNOBS.items():
        mp.setenv(k, str(v))
    mp.setattr(jt, "Trainer", lambda *a, **kw: _Recorded(seen, *a, **kw))
    mp.syspath_prepend(SCRIPTS)   # its main imports train_synthetic_flagship
    out = tmp_path_factory.mktemp("jab") / "ab.json"
    mp.setattr(sys, "argv", ["x", str(out)])
    try:
        script.main()
    finally:
        mp.undo()
    assert list(json.loads(out.read_text())["arms"]) == list(ab_features.ARMS)
    return seen


def test_arms_match_script(jax_arms):
    cfgs = ab_features.arm_configs(KNOBS["AB_ITERS"])
    assert tuple(cfgs) == ab_features.ARMS
    base = cfgs["baseline"]
    for (jcfg, _), (name, cfg) in zip(jax_arms, cfgs.items()):
        assert_config_equal(cfg, jcfg, name)
        assert (cfg != base) == (name != "baseline"), name
    assert base.render.tile_capacity == 1536 and base.impl == "tiled"
    assert (base.densify_from, base.densify_interval) == (300, 150)


def test_init_points_match_script(jax_arms):
    """Every arm starts from the script's min(8000, capacity // 4) noisy
    surface samples."""
    from robosimgs_tpu_torch.tools.flagship import scene_mesh
    n = KNOBS["AB_CAPACITY"] // 4
    rng = np.random.default_rng(0)
    scene, _ = scene_mesh(11)
    pts = scene.sample_surface(n, seed=1)
    pts = (pts + rng.normal(scale=0.01, size=pts.shape)).astype(np.float32)
    for _, init in jax_arms:
        means = np.asarray(jax.device_get(init.means))
        assert means.shape[0] == KNOBS["AB_CAPACITY"]
        np.testing.assert_array_equal(means[:n], pts)


def test_one_step_of_each_arm_on_cpu(tmp_path):
    out = tmp_path / "ab.json"
    res = ab_features.run(str(out), res=32, iters=1, capacity=2048,
                          n_views=4, n_hold=1, device="cpu", progress=False)
    got = json.loads(out.read_text())
    assert list(got["arms"]) == list(res["arms"]) == list(ab_features.ARMS)
    assert got["arms"] == res["arms"] and set(res["seconds"]) == set(res["arms"])
    assert got["config"] == {"res": 32, "iters": 1, "capacity": 2048,
                             "views": 3, "holdout": 1,
                             "scene": "flagship build_scene(11)"}
    for name, row in got["arms"].items():
        assert set(row) == ARM_KEYS, name
        assert math.isfinite(row["final_loss"]), name
        assert row["alive"] == 512, name
    # an arm filter keeps only the arms it names
    only = ab_features.run(str(tmp_path / "two.json"), res=32, iters=1,
                           capacity=2048, n_views=4, n_hold=1,
                           arms=["depth", "absgrad"], device="cpu",
                           progress=False)
    assert list(only["arms"]) == ["absgrad", "depth"]
