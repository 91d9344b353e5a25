"""tools/multihost_rehearsal.py against the JAX package's
scripts/multihost_rehearsal.py on the CPU: the script's build_problem()
inputs (carried across by core/convert.py) through the tool's 8 gloo
ranks joined by initialize_multihost on a (2, 4) mesh; every rank's
loss after the two DP steps within rtol 1e-6 of the script's
single-process run_steps on a (2, 4) mesh of 8 JAX CPU devices, and the
tool's own world-1 loss too. Then the tool's main() on its own scene."""

import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from robosimgs_tpu.parallel.mesh import make_mesh as jmake_mesh

from robosimgs_tpu_torch.core.convert import (camera_from_numpy,
                                              train_state_from_numpy)
from robosimgs_tpu_torch.tools import multihost_rehearsal as mh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def script():
    saved = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "multihost_rehearsal",
            os.path.join(ROOT, "scripts", "multihost_rehearsal.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def test_ranks_match_the_scripts_single_process_loss(script):
    jcfg, frames, targets, state = script.build_problem()
    want = script.run_steps(jcfg, frames, targets, state,
                            jmake_mesh(n_data=script.N_PROC,
                                       n_tile=script.LOCAL_DEVS))
    cfg = mh.train_config()
    assert (cfg.render.tile_capacity, cfg.render.ref_gaussian_chunk,
            cfg.scene_extent, cfg.impl) == (
        jcfg.render.tile_capacity, jcfg.render.ref_gaussian_chunk,
        jcfg.scene_extent, jcfg.impl)
    cams = [camera_from_numpy(jax.device_get(f.camera), "cpu")
            for f in frames]
    got = mh.rehearse(cfg, cams, np.asarray(targets),
                      train_state_from_numpy(_np(state), "cpu"), "cpu",
                      steps=script.STEPS)
    assert got["processes"] == script.N_PROC * script.LOCAL_DEVS == 8
    assert got["data_rows_outermost"] and got["match"]
    np.testing.assert_allclose(got["losses"], [want] * 8, rtol=1e-6)
    np.testing.assert_allclose(got["single_process_loss"], want, rtol=1e-6)


def test_main_on_its_own_scene(capsys):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert mh.main(["--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(n)
    lines = capsys.readouterr().out.splitlines()
    assert sum(x.startswith("MULTIHOST_LOSS pid=") for x in lines) == 8
    res = json.loads(lines[-1][len("RESULT "):])
    assert res["match"] and res["backend"] == "gloo"
    assert res["mesh"] == [2, 4] and res["steps"] == 2
