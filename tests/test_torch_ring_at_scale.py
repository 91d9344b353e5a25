"""tools/ring_at_scale.py against the JAX package's
scripts/ring_at_scale.py on the CPU, at 4,096 Gaussians.

The script runs one configuration a process (`--n 4096 --gather G`, 8
virtual devices): both gathers run here as subprocesses, side by side
with the tool on 2 gloo CPU ranks, which is fed the script's own
jax.random draw (core/convert.py). The loss is that of the whole set's
render, whatever the sharding: loss0 and loss1 within rtol 1e-5 of the
script's; the ring against the all_gather step within rtol 1e-6 (as
tests/test_ring.py holds the JAX pair). The render law's rows for world
2 carry both paths' rgb sums (equal within 1e-6 relative) and no device
bytes on the CPU; rank 0's merged ring blocks equal the whole set's
binning."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from robosimgs_tpu.core.types import Gaussians as JGaussians

from robosimgs_tpu_torch.core.convert import gaussians_from_numpy
from robosimgs_tpu_torch.render.binning import bin_and_gather_packed
from robosimgs_tpu_torch.render.project import project
from robosimgs_tpu_torch.tools import ring_at_scale as rs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "ring_at_scale.py")
N = 4096


@pytest.fixture(scope="module")
def runs():
    """(the tool's result on 2 ranks, {gather: the script's
    CONFIG_RESULT}); the script's two processes run while the tool
    does."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ""}
    procs = {gather: subprocess.Popen(
        [sys.executable, "-u", SCRIPT, "--n", str(N), "--gather", gather],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for gather in rs.GATHERS}
    try:
        g = JGaussians.random(jax.random.PRNGKey(1), N, sh_degree=2,
                              extent=1.5)
        got = rs.ring_at_scale("cpu", ns=(N,), world=2, law_worlds=(2,),
                               law_ns=(N,), gaussians={
                                   N: gaussians_from_numpy(jax.device_get(g),
                                                           "cpu")})
        want = {}
        for gather, p in procs.items():
            out, _ = p.communicate(timeout=600)
            assert p.returncode == 0, out
            line = [x for x in out.splitlines()
                    if x.startswith("CONFIG_RESULT ")][0]
            want[gather] = json.loads(line[len("CONFIG_RESULT "):])
    finally:
        for p in procs.values():
            p.kill()
            p.wait()
    return got, want


def _step(got, gather):
    return [r for r in got["executed_steps"] if r["gather"] == gather][0]


@pytest.mark.parametrize("gather", rs.GATHERS)
def test_losses_match_the_script(runs, gather):
    got, want = runs
    row = _step(got, gather)
    assert row["n"] == want[gather]["n"] == N
    for key in ("loss0", "loss1"):
        np.testing.assert_allclose(row[key], want[gather][key], rtol=1e-5,
                                   err_msg=key)
    assert row["peak_bytes"] == [None, None]
    assert all(x > 0 for x in row["peak_rss_mb"])


def test_ring_step_matches_all_gather_step(runs):
    got, _ = runs
    ring, ag = _step(got, "ring"), _step(got, "all_gather")
    for key in ("loss0", "loss1"):
        np.testing.assert_allclose(ring[key], ag[key], rtol=1e-6,
                                   err_msg=key)
    assert got["devices"] == 2 and got["device"] == "cpu"


def test_render_law_rows_for_world_two(runs):
    got, _ = runs
    rows = got["render_path_peak_bytes_per_rank"]
    assert [(r["devices"], r["n"]) for r in rows] == [(2, N)]
    row = rows[0]
    np.testing.assert_allclose(row["ring_value"], row["all_gather_value"],
                               rtol=1e-6)
    assert row["ring_peak_bytes"] == row["all_gather_peak_bytes"] == [None,
                                                                      None]


def test_merged_blocks_are_the_whole_sets(runs):
    got, _ = runs
    blocks = got["blocks"]
    g = JGaussians.random(jax.random.PRNGKey(1), N, sh_degree=2, extent=1.5)
    cfg = rs.train_config().render
    with torch.no_grad():
        geom, feat, counts, _ = bin_and_gather_packed(project(
            gaussians_from_numpy(jax.device_get(g), "cpu"), rs.camera("cpu"),
            cfg), rs.RES, rs.RES, cfg)
    np.testing.assert_array_equal(blocks["counts"], counts.numpy())
    kmask = np.arange(cfg.tile_capacity)[None, None, :] < \
        counts.numpy()[:, None, None]
    for name, want in (("geom", geom), ("feat", feat)):
        np.testing.assert_allclose(np.where(kmask, blocks[name], 0.0),
                                   np.where(kmask, want.numpy(), 0.0),
                                   atol=1e-5, rtol=0, err_msg=name)
