"""tools/train_masknet.py against the JAX package's scripts/train_masknet.py
on the CPU, at 3 steps, size 32 and 4 training scenes, plain and
--finetune (the script's MASKNET_FINETUNE=1).

The script's main() runs with its knobs set and three things replaced:
save_params by a recorder (the JAX package's weights are never
written), the automatic generator by a stub (only its training result
is compared) and make_scene by the port's (the port's scenes are held
to JAX's by tests/test_torch_masknet.py; mesh edges may flip a pixel).
Plain training starts from flax's initialisers at PRNGKey(seed); the
tool is handed the same parameters (its own initialisers draw from a
torch.Generator). Tolerances are tests/test_torch_masknet.py's: the
losses within 1e-4 relative, and the held-out IoU within 1e-3 (a few
of the 12 x 1,024 held-out pixels may threshold the other way, 0.1 %
of the pixels at most). Then main() with --out leaves the checked-in
weights byte-identical, and refuses to write over them."""

import hashlib
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosimgs_tpu.artic import masknet as jm

from robosimgs_tpu_torch.artic import masknet as pm
from robosimgs_tpu_torch.core.convert import masknet_params_from_numpy
from robosimgs_tpu_torch.tools import train_masknet as tm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, SIZE, SCENES, SEED = 3, 32, 4, 0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_scene(seed, size, max_parts=3, scan_like=False, flap=False,
               device="cpu"):
    return pm.make_scene(seed, size, max_parts, scan_like, flap,
                         device="cpu")


class _NoGenerator:
    def __init__(self, *a, **kw):
        pass

    def generate(self, image):
        return []


def run_script(finetune: bool):
    """(the script's train_masknet result, the initial parameters it
    trained from)."""
    saved = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "train_masknet", os.path.join(ROOT, "scripts", "train_masknet.py"))
        script = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(script)
    finally:
        sys.path[:] = saved
    seen = {}
    real = jm.train_masknet

    def recording(**kw):
        if kw["init_params"] is None:
            kw["init_params"] = jm.MaskUNet().init(
                jax.random.PRNGKey(kw["seed"]),
                jnp.zeros((1, kw["size"], kw["size"], 4)))
        seen["init"] = kw["init_params"]
        seen["kw"] = kw
        seen["res"] = real(**kw)
        return seen["res"]

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jm, "train_masknet", recording)
        mp.setattr(jm, "make_scene", port_scene)
        mp.setattr(jm, "save_params", lambda params, path: None)
        mp.setattr(jm, "MaskNetGenerator", _NoGenerator)
        mp.setattr(sys, "argv", ["train_masknet.py", str(STEPS), str(SIZE)])
        mp.setenv("MASKNET_FINETUNE", "1" if finetune else "0")
        mp.setenv("MASKNET_SCENES", str(SCENES))
        mp.setenv("MASKNET_SEED", str(SEED))
        script.main()
    finally:
        mp.undo()
    return seen


@pytest.mark.parametrize("finetune", [False, True])
def test_holdout_iou_matches_the_script(finetune, monkeypatch, tmp_path):
    want = run_script(finetune)
    init = masknet_params_from_numpy(jax.device_get(want["init"]))
    got_kw = {}
    real = pm.train_masknet

    def from_jax_init(**kw):
        got_kw.update(kw)
        if kw["init_params"] is None:
            kw["init_params"] = init
        return real(**kw)

    monkeypatch.setattr(tm, "train_masknet", from_jax_init)
    got = tm.run(STEPS, SIZE, finetune, SCENES, SEED, "cpu",
                 out=str(tmp_path / "w.msgpack"), log=lambda s: None)
    for key in ("steps", "size", "batch", "n_scenes", "seed", "lr",
                "flap_frac", "crop_aug"):
        assert got_kw[key] == want["kw"][key], key
    if finetune:
        for k, v in pm.load_params().items():
            torch.testing.assert_close(got_kw["init_params"][k], v, rtol=0,
                                       atol=0)
    res = want["res"]
    np.testing.assert_allclose(got["losses"], res.losses, rtol=1e-4)
    assert abs(got["holdout_iou"] - res.holdout_iou) <= 1e-3, (
        got["holdout_iou"], res.holdout_iou)
    assert 0.0 <= got["checked_in_holdout_iou"] <= 1.0
    assert len(got["best_ious"]) == tm.FRESH
    assert os.path.getsize(tmp_path / "w.msgpack") > 0


def _digest(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def test_main_leaves_the_checked_in_weights(tmp_path, capsys):
    before = _digest(pm.DEFAULT_WEIGHTS)
    out = str(tmp_path / "trained.msgpack")
    assert tm.main(["2", "32", "--scenes", "2", "--device", "cpu",
                    "--out", out]) == 0
    res = json.loads(capsys.readouterr().out.splitlines()[-1][
        len("RESULT "):])
    assert res["out"] == out and np.isfinite(res["holdout_iou"])
    assert _digest(pm.DEFAULT_WEIGHTS) == before
    assert set(pm.load_params(out)) == set(pm.load_params())
    with pytest.raises(ValueError, match="checked-in"):
        tm.main(["2", "32", "--device", "cpu", "--out",
                 pm.DEFAULT_WEIGHTS])
    assert _digest(pm.DEFAULT_WEIGHTS) == before
