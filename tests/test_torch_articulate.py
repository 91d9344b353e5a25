"""Mesh to URDF through the port (Segmenter.run with the checked-in mask
weights, and cli.articulate --device cpu) against the JAX package on the
open box of tools/workloads.py::open_box_parts(8, 5), on the CPU.

The JAX package's mesh rasterizer is jitted here (op by op it costs
seconds a view); its results are XLA's either way. Tolerances: face
labels equal, or any flips counted and at most 0.5 % of the faces; the
rendered masks (mask_*.npy) flipped on at most 0.1 % of pixels; the
geometric CLI's URDF and metadata.json within 1e-6; the masknet CLI's
hinge axis within 1e-4.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from robosimgs_tpu.artic import render_views as jviews
from robosimgs_tpu.artic import segmentation as jseg
from robosimgs_tpu.cli import articulate as jcli
from robosimgs_tpu.render import mesh_raster as jraster
from robosimgs_tpu.utils import meshio as jmeshio
from robosimgs_tpu_torch.artic import segmentation as seg
from robosimgs_tpu_torch.cli import articulate as cli
from robosimgs_tpu_torch.tools.workloads import open_box_parts
from robosimgs_tpu_torch.utils.meshio import concatenate, load_mesh, save_mesh

MAX_FACE_FLIP_SHARE = 5e-3
MAX_FLIP_SHARE = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # the suite runs files in parallel workers, where torch's CPU threads
    # spin against each other
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jitted_jax_raster():
    mp = pytest.MonkeyPatch()
    fn = jax.jit(jraster.rasterize_mesh, static_argnames=("cfg",))
    mp.setattr(jviews, "rasterize_mesh", fn)
    mp.setattr(jraster, "rasterize_mesh", fn)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def box():
    body, lid = open_box_parts(8, 5)
    mesh = concatenate([lid, body])
    c = lid.vertices.mean(0)
    seed_lid = lid.vertices[np.argmin(((lid.vertices - c) ** 2).sum(1))]
    front = np.array([0.0, -0.25, 0.0], np.float32)
    seed_body = body.vertices[np.argmin(((body.vertices - front) ** 2).sum(1))]
    return mesh, len(lid.faces), [seed_lid, seed_body]


def to_jax_mesh(m):
    return jmeshio.Mesh(vertices=m.vertices, faces=m.faces,
                        vertex_colors=m.vertex_colors)


def _face_labels(mesh, part):
    """Which of the mesh's faces a part holds (parts keep face order)."""
    key = {tuple(np.round(mesh.vertices[f].ravel(), 6)): i
           for i, f in enumerate(mesh.faces)}
    hit = np.zeros(len(mesh.faces), bool)
    hit[[key[tuple(np.round(part.vertices[f].ravel(), 6))]
         for f in part.faces]] = True
    return hit


@pytest.mark.parametrize("fusion", [1, 3])
def test_segmenter_run_matches_jax(box, fusion):
    mesh, n_lid, seeds = box
    kw = dict(resolution=96, mask_dilate_px=1, fusion_views=fusion)
    got = seg.Segmenter(mesh, device="cpu", **kw).run(
        seeds, part_names=["lid", "box body"])
    want = jseg.Segmenter(to_jax_mesh(mesh), **kw).run(
        seeds, part_names=["lid", "box body"])
    assert got.best_view == want.best_view
    assert got.prompts == want.prompts
    hit = _face_labels(mesh, got.parts["RED"])
    jhit = _face_labels(mesh, want.parts["RED"])
    flips = int((hit != jhit).sum())
    assert flips <= MAX_FACE_FLIP_SHARE * len(hit), flips
    assert 0 < hit.sum() < len(hit)
    for color in ("RED", "GREEN"):
        assert (got.masks[color] != want.masks[color]).mean() <= MAX_FLIP_SHARE


def _run_clis(tmp_path, mesh, args):
    outs = {}
    for tag, main, extra in (("port", cli.main, ["--device", "cpu"]),
                             ("jax", jcli.main, [])):
        d = tmp_path / tag
        d.mkdir()
        save_mesh(str(d / "box.glb"), mesh)
        main([str(d / "box.glb"), "--resolution", "96", *args, *extra])
        outs[tag] = d / "box_output"
    return outs


def _close(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert a == pytest.approx(b, abs=1e-6), path
    else:
        assert a == b, path


def test_cli_geometric_matches_jax(tmp_path, box, capsys):
    mesh, _, seeds = box
    points = [str(float(x)) for s in seeds for x in s]
    outs = _run_clis(tmp_path, mesh, ["--points", *points, "--part-names",
                                      "box lid", "box body"])
    printed = capsys.readouterr().out
    assert ("Next: validate with `python -m robosimgs_tpu_torch.cli."
            "validate_urdf") in printed
    meta = [json.loads((o / "urdf" / "metadata.json").read_text())
            for o in (outs["port"], outs["jax"])]
    _close(meta[0], meta[1])
    urdf = [(o / "urdf" / "articulated_object.urdf").read_text()
            for o in (outs["port"], outs["jax"])]
    from robosimgs_tpu_torch.scenegen.urdf_fk import URDFModel
    models = [URDFModel.parse(u) for u in urdf]
    assert models[0].validate() == []
    j0, j1 = models[0].movable[0], models[1].movable[0]
    np.testing.assert_allclose(j0.axis, j1.axis, atol=1e-6)
    assert (j0.lower, j0.upper) == (j1.lower, j1.upper)
    segd = [o / "segmentation" for o in (outs["port"], outs["jax"])]
    assert sorted(os.listdir(segd[0])) == sorted(os.listdir(segd[1]))
    for f in os.listdir(segd[0]):
        if f.endswith(".npy"):
            a, b = np.load(segd[0] / f), np.load(segd[1] / f)
            assert (a != b).mean() <= MAX_FLIP_SHARE, f
        if f.endswith(".glb"):
            np.testing.assert_array_equal(load_mesh(str(segd[0] / f)).faces,
                                          load_mesh(str(segd[1] / f)).faces)


def test_cli_masknet_fusion_matches_jax(tmp_path, box):
    mesh, _, seeds = box
    points = [str(float(x)) for s in seeds for x in s]
    outs = _run_clis(tmp_path, mesh, ["--points", *points, "--part-names",
                                      "box lid", "box body", "--mask-backend",
                                      "masknet", "--fusion-views", "3"])
    meta = [json.loads((o / "urdf" / "metadata.json").read_text())
            for o in (outs["port"], outs["jax"])]
    np.testing.assert_allclose(meta[0]["hinge"]["axis"],
                               meta[1]["hinge"]["axis"], atol=1e-4)
    assert meta[0]["joint_limits"] == meta[1]["joint_limits"]
    for f in ("part_RED.glb", "part_GREEN.glb"):
        assert os.path.exists(outs["port"] / "segmentation" / f)
    assert os.listdir(outs["port"] / "segmentation" / "debug")


def test_cli_presegmented_parts_match_jax(tmp_path, box):
    """--lid/--body skip segmentation: the same URDF as the JAX CLI's."""
    mesh, n_lid, _ = box
    body, lid = open_box_parts(8, 5)
    save_mesh(str(tmp_path / "lid.glb"), lid)
    save_mesh(str(tmp_path / "body.glb"), body)
    metas = []
    for tag, main, extra in (("port", cli.main, ["--device", "cpu"]),
                             ("jax", jcli.main, [])):
        out = tmp_path / tag
        shutil.copytree(tmp_path, out, ignore=shutil.ignore_patterns(
            "port", "jax"))
        main([str(out / "lid.glb"), "--lid", str(out / "lid.glb"), "--body",
              str(out / "body.glb"), "--limit-upper", "1.2", *extra])
        metas.append(json.loads((out / "lid_output" / "urdf"
                                 / "metadata.json").read_text()))
    _close(metas[0], metas[1])
    assert metas[0]["joint_limits"]["upper"] == 1.2


def test_cli_default_device_is_cuda():
    args = cli.build_parser().parse_args(["m.glb"])
    assert args.device == "cuda"
    jargs = jcli.build_parser().parse_args(["m.glb"])
    assert set(vars(args)) - set(vars(jargs)) == {"device"}
