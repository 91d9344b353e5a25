"""The port's articulation toolchain (robosimgs_tpu_torch/artic/ and its
three CLIs) against the JAX package on the CPU: the same numpy meshes,
images and scripted model answers go through both, and the outputs are
compared at the tolerance stated in each case.

Tolerances: `_min_dists` within 1e-4 m; HingeResult position and axis
within 1e-5, contact counts equal; URDF and metadata.json values within
1e-6; the blur within 1e-5; views: mask flips on at most 0.1 % of pixels
(XLA contracts the mesh edge functions into FMAs, torch does not), rgb
within 1e-5 where both cover; PNGs compared by decoded pixels (the
compressors differ), within one 8-bit step where both cover.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from robosimgs_tpu.artic import hinge as jhinge
from robosimgs_tpu.artic import mllm as jmllm
from robosimgs_tpu.artic import physics as jphysics
from robosimgs_tpu.artic import pipeline as jpipeline
from robosimgs_tpu.artic import render_views as jviews
from robosimgs_tpu.artic import urdf_builder as jurdf
from robosimgs_tpu.artic import visual_prompt as jprompt
from robosimgs_tpu.cli import estimate_physics as jcli_physics
from robosimgs_tpu.cli import validate_urdf as jcli_validate
from robosimgs_tpu.cli import visualize_parts as jcli_visualize
from robosimgs_tpu.utils import meshio as jmeshio
from robosimgs_tpu_torch.artic import hinge, mllm, physics, pipeline
from robosimgs_tpu_torch.artic import render_views as views
from robosimgs_tpu_torch.artic import urdf_builder, visual_prompt
from robosimgs_tpu_torch.artic.config import ArticConfig
from robosimgs_tpu_torch.cli import estimate_physics as cli_physics
from robosimgs_tpu_torch.cli import validate_urdf as cli_validate
from robosimgs_tpu_torch.cli import visualize_parts as cli_visualize
from robosimgs_tpu_torch.scenegen.urdf_fk import URDFModel
from robosimgs_tpu_torch.utils.bake import subdivide_mesh
from robosimgs_tpu_torch.utils.imresize import read_png_rgb
from robosimgs_tpu_torch.utils.meshio import Mesh, concatenate, load_mesh

MAX_FLIP_SHARE = 1e-3


def box_mesh(size=(0.5, 0.5, 0.2), offset=(0, 0, 0)):
    sx, sy, sz = size
    v = np.array([[x, y, z] for x in (-sx, sx) for y in (-sy, sy)
                  for z in (-sz, sz)], np.float32) + np.asarray(offset,
                                                                np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return Mesh(vertices=v, faces=f)


def to_jax_mesh(m: Mesh) -> jmeshio.Mesh:
    return jmeshio.Mesh(vertices=m.vertices, faces=m.faces,
                        vertex_colors=m.vertex_colors, uv=m.uv,
                        texture=m.texture)


def open_box(n_body=8, n_lid=5):
    """The body/lid pair of tools/workloads.py's grid boxes, the lid
    opened 60 degrees about the body's back top edge (y = 0.25, z = 0.1)."""
    from robosimgs_tpu_torch.tools.workloads import open_box_parts
    return open_box_parts(n_body, n_lid)


def assert_hinge_equal(got, want):
    np.testing.assert_allclose(got.position, want.position, atol=1e-5)
    np.testing.assert_allclose(got.axis, want.axis, atol=1e-5)
    assert got.confidence == pytest.approx(want.confidence, abs=1e-5)
    assert (got.contact_count_a, got.contact_count_b) == (
        want.contact_count_a, want.contact_count_b)


def assert_images_agree(got, want, got_mask, want_mask, atol=1e-5):
    """Mask flips on at most 0.1 % of pixels; rgb within atol where both
    cover."""
    flips = (got_mask != want_mask).mean()
    assert flips <= MAX_FLIP_SHARE, flips
    both = got_mask & want_mask
    np.testing.assert_allclose(got[both], want[both], atol=atol)


# -- mllm utilities --------------------------------------------------------

def test_with_retry_succeeds_after_failures():
    for mod in (mllm, jmllm):
        calls = []

        def fn(seed):
            calls.append(seed)
            if len(calls) < 3:
                raise RuntimeError("transient")
            return f"ok@{seed}"

        assert mod.with_retry(fn, tries=5, sleep_s=0.0) == "ok@102"
        assert calls == [100, 101, 102]  # seed bumps per retry


def test_with_retry_raises_typed_error():
    with pytest.raises(mllm.MLLMError, match="failed after 2"):
        mllm.with_retry(lambda s: (_ for _ in ()).throw(RuntimeError("boom")),
                        tries=2, sleep_s=0.0)


@pytest.mark.parametrize("text", [
    '{"a": 1}', 'blah ```json\n{"a": 2}\n``` blah',
    'prefix {"a": {"b": 3}} suffix', "no json here"])
def test_extract_json_variants(text):
    try:
        want = jmllm.extract_json(text)
    except ValueError:
        with pytest.raises(ValueError):
            mllm.extract_json(text)
        return
    assert mllm.extract_json(text) == want


def test_openai_chat_request_shaping_with_stub_transport():
    """The request body the JAX client sends, its images encoded by the
    port's PNG writer (no Pillow) to the same pixels."""
    calls = {}

    def transport(model, messages, seed, timeout_s):
        calls.update(model=model, messages=messages, seed=seed,
                     timeout_s=timeout_s)
        return '{"ok": true}'

    img = np.zeros((8, 8, 3), np.float32)
    img[0, 0] = 1.0
    img[3, 5] = (0.2, 0.5, 0.7)
    out = mllm.OpenAIChat(model="gpt-4-turbo", transport=transport).chat(
        "describe", images=[img, img], seed=100)
    assert out == '{"ok": true}'
    got = calls["messages"]
    assert (calls["model"], calls["seed"], calls["timeout_s"]) == (
        "gpt-4-turbo", 100, 30.0)
    jmllm.OpenAIChat(model="gpt-4-turbo", transport=transport).chat(
        "describe", images=[img, img], seed=100)
    want = calls["messages"]
    import base64
    import io
    assert len(got) == len(want) == 1 and got[0]["role"] == "user"
    assert got[0]["content"][0] == want[0]["content"][0] == {
        "type": "text", "text": "describe"}
    assert len(got[0]["content"]) == len(want[0]["content"]) == 3
    for g, w in zip(got[0]["content"][1:], want[0]["content"][1:]):
        urls = [p["image_url"]["url"] for p in (g, w)]
        assert all(u.startswith("data:image/png;base64,") for u in urls)
        pix = [np.asarray(Image.open(io.BytesIO(
            base64.b64decode(u.split(",", 1)[1])))) for u in urls]
        np.testing.assert_array_equal(pix[0], pix[1])


# -- hinge -----------------------------------------------------------------

@pytest.mark.parametrize("n", [5, 2048, 2500])
def test_min_dists_matches_jax(n):
    """Chunks of 2048 rows: fewer, exactly one, and a partial second."""
    rng = np.random.default_rng(n)
    a = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (777, 3)).astype(np.float32)
    got = hinge._min_dists(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    want = np.asarray(jhinge._min_dists(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=1e-4)
    exact = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1)).min(1)
    np.testing.assert_allclose(got, exact, atol=1e-3)


def _hinge_cases():
    body = box_mesh((0.5, 0.5, 0.2))
    lid = box_mesh((0.5, 0.02, 0.02), offset=(0, 0.5, 0.24))
    # a subdivided pair whose lid carries a mislabeled patch lying on the
    # body's top away from the hinge: its fake contacts tilt the axis
    # until the trimming loop drops them and refits
    sub_body = subdivide_mesh(box_mesh((0.5, 0.5, 0.2)), 3)
    sub_lid = concatenate([
        subdivide_mesh(box_mesh((0.5, 0.03, 0.02), offset=(0, 0.5, 0.23)), 3),
        subdivide_mesh(box_mesh((0.04, 0.04, 0.01), offset=(0.2, 0.1, 0.212)),
                       1)])
    ob_body, ob_lid = open_box()
    return {
        "contact_edge": (body, lid, 0.01, 0),
        "far_apart": (box_mesh((0.1, 0.1, 0.1)),
                      box_mesh((0.1, 0.1, 0.1), offset=(0, 0, 5.0)), 0.001, 0),
        "subdivided_trim0": (sub_lid, sub_body, 0.01, 0),
        "subdivided_trim2": (sub_lid, sub_body, 0.01, 2),
        "open_box": (ob_lid, ob_body, 0.01, 0),
    }


HINGE_CASES = _hinge_cases()


@pytest.mark.parametrize("name", list(HINGE_CASES))
def test_hinge_matches_jax(name):
    a, b, margin, trim = HINGE_CASES[name]
    got = hinge.HingeDetector(a, b, margin, trim=trim, device="cpu").detect()
    want = jhinge.HingeDetector(to_jax_mesh(a), to_jax_mesh(b), margin,
                                trim=trim).detect()
    assert_hinge_equal(got, want)
    assert np.isfinite(got.position).all()
    assert 0.0 <= got.confidence <= 1.0
    if name == "contact_edge":
        # contact around y=0.5, z~0.2; the axis is +-x (the long contact
        # direction)
        assert abs(abs(got.axis[0]) - 1.0) < 0.1
        assert got.contact_count_a > 0 and got.contact_count_b > 0
    if name == "subdivided_trim2":
        untrimmed = HINGE_CASES["subdivided_trim0"]
        plain = hinge.HingeDetector(untrimmed[0], untrimmed[1],
                                    device="cpu").detect()
        # trimming drops the patch's contacts: the axis turns back to x
        assert abs(got.axis[0]) > abs(plain.axis[0])
        assert abs(abs(got.axis[0]) - 1.0) < 1e-4
    if name == "open_box":
        assert abs(got.axis[0]) > 0.99
        assert np.hypot(got.position[1] - 0.25, got.position[2] - 0.1) < 0.02


def test_entry_points_default_to_cuda():
    """The slice's device entry points run on the card unless asked for
    the CPU; without a card they raise (no CPU fallback)."""
    import inspect
    for fn in (hinge.HingeDetector, pipeline.ArticulationPipeline,
               views.view_camera, views.render_canonical_views):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            hinge.HingeDetector(box_mesh(), box_mesh()).detect()


# -- urdf builder ----------------------------------------------------------

def _build(mod, fixed: bool):
    b = mod.URDFBuilder("testobj")
    if fixed:
        b.add_link("a").add_link("b").add_fixed_joint(
            "j", "a", "b", origin_xyz=(1, 2, 3))
        return b
    b.add_link("body", "body.glb", mass=0.5)
    b.add_link("lid", "lid.glb", mass=0.2)
    b.add_revolute_joint("hinge", "body", "lid", axis=(0, 0, 1),
                         lower=0.0, upper=1.57)
    return b


@pytest.mark.parametrize("fixed", [False, True], ids=["revolute", "fixed"])
def test_urdf_builder_output_parses(fixed):
    s = _build(urdf_builder, fixed).to_string()
    assert s == _build(jurdf, fixed).to_string()
    assert s.startswith('<?xml version="1.0"?>')
    m = URDFModel.parse(s)
    assert m.validate() == []
    if fixed:
        np.testing.assert_allclose(m.fk()["b"][:3, 3], [1, 2, 3], atol=1e-6)
    else:
        assert m.root == "body"
        assert m.movable[0].upper == pytest.approx(1.57)
        assert m.links["body"].mass == 0.5


@pytest.mark.parametrize("names", [
    {"RED": "box lid", "GREEN": "box body"},
    {"A": "container", "B": "hinged door"}])
def test_identify_lid_and_body(names):
    got = pipeline.identify_lid_and_body(names)
    assert got == jpipeline.identify_lid_and_body(names)
    assert names[got[0]] in ("box lid", "hinged door")


# -- pipeline --------------------------------------------------------------

URDF_RESPONSE = (
    '{"object_type": "box", "base_link": "base", "lower_rad": 0.0, '
    '"upper_rad": 1.57, "effort": 5, "velocity": 2, "friction": 0.5, '
    '"damping": 0.2, "base_mass_kg": 0.5, "movable_mass_kg": 0.2, '
    '"reasoning": "typical box lid"}')


def _close(a, b, path=""):
    """Nested JSON values equal, floats within 1e-6."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, abs=1e-6), path
    else:
        assert a == b, path


def _run_pipelines(tmp_path, lid, body, swap=False, **kw):
    out = {}
    for tag, mod, conv, extra in (
            ("port", pipeline, lambda m: m, {"device": "cpu"}),
            ("jax", jpipeline, to_jax_mesh, {})):
        params = mod.URDFParams(swap_base_movable=True) if swap else None
        mllm_ = None if swap else mod_mllm(mod)
        pipe = mod.ArticulationPipeline(conv(lid), conv(body), mllm=mllm_,
                                        **extra, **kw)
        d = tmp_path / tag
        meta = pipe.generate(str(d), params=params, movable_name="lid",
                             base_name="body")
        out[tag] = (d, meta)
    return out


def mod_mllm(mod):
    ScriptedMLLM = (mllm if mod is pipeline else jmllm).ScriptedMLLM
    return ScriptedMLLM(responses=[("Recommend URDF parameters",
                                    URDF_RESPONSE)])


def _assert_artifacts_match(runs):
    (d, meta), (jd, jmeta) = runs["port"], runs["jax"]
    assert_hinge_equal(meta["hinge_result"], jmeta["hinge_result"])
    md = json.loads((d / "metadata.json").read_text())
    _close(md, json.loads((jd / "metadata.json").read_text()))
    model = URDFModel.parse(meta["urdf_path"])
    jmodel = URDFModel.parse(jmeta["urdf_path"])
    assert model.validate() == [] == jmodel.validate()
    for j, jj in zip(model.joints, jmodel.joints):
        assert (j.name, j.type, j.parent, j.child) == (
            jj.name, jj.type, jj.parent, jj.child)
        np.testing.assert_allclose(j.axis, jj.axis, atol=1e-6)
        assert (j.lower, j.upper) == pytest.approx((jj.lower, jj.upper),
                                                   abs=1e-6)
    for name in ("base_mesh", "movable_mesh"):
        m = load_mesh(str(d / md["files"][name]))
        jm = jmeshio.load_mesh(str(jd / md["files"][name]))
        np.testing.assert_allclose(m.vertices, jm.vertices, atol=1e-6)
        np.testing.assert_array_equal(m.faces, jm.faces)
    return md, model


def test_articulation_pipeline_end_to_end(tmp_path):
    body = box_mesh((0.5, 0.5, 0.2), offset=(1.0, 2.0, 0.0))
    lid = box_mesh((0.5, 0.03, 0.02), offset=(1.0, 2.5, 0.23))
    runs = _run_pipelines(tmp_path, lid, body)
    md, model = _assert_artifacts_match(runs)
    assert model.movable[0].upper == pytest.approx(1.57)
    # hinge moved to origin: centered meshes' contact near origin
    lid_c = load_mesh(str(runs["port"][0] / "lid_centered.glb"))
    assert np.abs(lid_c.vertices).min() < 0.6
    assert set(md["hinge"]) >= {"original_position", "axis",
                                "axis_confidence", "translation_applied"}
    # metadata limits match URDF limits (the upstream shipped a mismatch)
    assert md["joint_limits"]["upper"] == pytest.approx(model.movable[0].upper)
    assert md["joint_limits"]["lower"] == pytest.approx(model.movable[0].lower)
    assert md["mllm_recommendations"]["parameters_used"] is True


def test_pipeline_swap_base_movable(tmp_path):
    body = box_mesh((0.5, 0.5, 0.2))
    lid = box_mesh((0.5, 0.03, 0.02), offset=(0, 0.5, 0.23))
    runs = _run_pipelines(tmp_path, lid, body, swap=True)
    md, model = _assert_artifacts_match(runs)
    # swapped: "body" is now the movable link
    assert model.movable[0].child == "body"
    assert md["files"]["movable_mesh"] == "body_centered.glb"


def test_pipeline_open_box_trimmed(tmp_path):
    body, lid = open_box()
    runs = _run_pipelines(tmp_path, lid, body, hinge_trim=2)
    _assert_artifacts_match(runs)


# -- config ----------------------------------------------------------------

def test_artic_config_dirs(tmp_path):
    from robosimgs_tpu.artic.config import ArticConfig as JArticConfig
    inp = tmp_path / "openbox.glb"
    inp.write_bytes(b"")
    cfg = ArticConfig(input_file=str(inp))
    jcfg = JArticConfig(input_file=str(inp))
    assert cfg.output_dir.endswith("openbox_output")
    for sub in ("segmentation", "parts", "urdf"):
        assert os.path.isdir(os.path.join(cfg.output_dir, sub))
    assert vars(cfg) == vars(jcfg)


# -- physics ---------------------------------------------------------------

@pytest.mark.parametrize("method", ["mpm", "pbd"])
def test_material_tables_load(method):
    table = physics.load_material_table(method)
    assert table == jphysics.load_material_table(method)
    assert physics.MATERIAL_VOCABULARY == jphysics.MATERIAL_VOCABULARY
    if method == "mpm":
        assert set(physics.MATERIAL_VOCABULARY) <= set(table)
    else:
        assert "rubber" in table
        for row in table.values():
            assert 0 <= row["static_friction"] <= 2


def test_physics_estimate_mpm(tmp_path):
    img = np.random.default_rng(0).uniform(size=(32, 32, 3)).astype(
        np.float32)
    responses = [
        ("list the 3 most likely materials",
         '{"1": "rigid: wood", "2": "rigid: metal", "3": "deformable: rubber"}'),
        ("Refine them",
         '{"density": 650, "youngs_modulus": 5.5, "poisson_ratio": 0.3}'),
    ]
    ests = []
    for tag, mm, ph in (("port", mllm, physics), ("jax", jmllm, jphysics)):
        ests.append(ph.PhysicsEstimator(
            captioner=mm.StaticCaptioner("a wooden box"),
            scorer=mm.UniformScorer({"a photo of wood material": 2.0}),
            mllm=mm.ScriptedMLLM(responses=responses),
        ).estimate(img, out_path=str(tmp_path / f"{tag}.json")))
    est, jest = ests
    assert est.to_json() == jest.to_json()
    assert (est.method, est.material, est.refined) == ("mpm", "wood", True)
    assert est.params == {"density": 650, "youngs_modulus": 5.5,
                          "poisson_ratio": 0.3}
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())


def test_physics_estimate_pbd_no_mllm():
    img = np.zeros((16, 16, 3), np.float32)

    class PBDCoarse:
        def chat(self, prompt, images=(), seed=None):
            if "list the 3" in prompt:
                return ('{"1": "deformable: rubber", "2": "deformable: '
                        'gelatin", "3": "rigid: wood"}')
            raise RuntimeError("no refinement")

    est = physics.PhysicsEstimator(mllm=PBDCoarse()).estimate(img)
    jest = jphysics.PhysicsEstimator(mllm=PBDCoarse()).estimate(img)
    assert est.to_json() == jest.to_json()
    assert est.method == "pbd" and not est.refined
    assert "stretch_compliance" in est.params


# -- visual prompting ------------------------------------------------------

@pytest.mark.parametrize("std", [50.0, 400.0], ids=["std50", "window_cap"])
def test_blur_mask_prompt(std):
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(64, 64, 3)).astype(np.float32)
    mask = np.zeros((64, 64), bool)
    mask[20:40, 20:40] = True
    out = visual_prompt.blur_mask_prompt(torch.as_tensor(img),
                                         torch.as_tensor(mask), std=std).numpy()
    want = np.asarray(jprompt.blur_mask_prompt(jnp.asarray(img),
                                               jnp.asarray(mask), std=std))
    np.testing.assert_allclose(out, want, atol=1e-5)
    blurred = visual_prompt.gaussian_blur(torch.as_tensor(img), 30.0).numpy()
    np.testing.assert_allclose(
        blurred, np.asarray(jprompt.gaussian_blur(jnp.asarray(img), 30.0)),
        atol=1e-5)
    # inside the mask: untouched; outside: smoothed (lower variance)
    np.testing.assert_allclose(out[mask], img[mask], atol=1e-6)
    assert out[~mask].std() < img[~mask].std() * 0.6

    crop = visual_prompt.crop_prompt(img, mask, pad=4)
    np.testing.assert_array_equal(crop, jprompt.crop_prompt(img, mask, pad=4))
    assert crop.shape[0] <= 28 + 1 and crop.shape[1] <= 28 + 1


# -- canonical views -------------------------------------------------------

def _views_pair(mesh, tmp_path=None, **kw):
    got = views.render_canonical_views(
        mesh, out_dir=str(tmp_path / "port") if tmp_path else None,
        device="cpu", **kw)
    want = jviews.render_canonical_views(
        to_jax_mesh(mesh), out_dir=str(tmp_path / "jax") if tmp_path else None,
        **kw)
    assert set(got) == set(want)
    for name in got:
        g, w = got[name], want[name]
        gm, wm = np.isfinite(g["depth"]), np.isfinite(w["depth"])
        for key in ("clean", "marked"):
            assert g[key].shape == w[key].shape and np.isfinite(g[key]).all()
            assert_images_agree(g[key], w[key], gm, wm)
        both = gm & wm
        np.testing.assert_allclose(g["depth"][both], w["depth"][both],
                                   rtol=1e-6)
    return got, want


def test_oblique_views_mode():
    m = box_mesh((0.3, 0.3, 0.3))
    got, _ = _views_pair(m, resolution=48,
                         view_names=["top_oblique", "bottom_oblique"])
    assert set(got) == {"top_oblique", "bottom_oblique"}


def test_canonical_views_with_markers_and_artifacts(tmp_path):
    """The six axis-aligned views of the open box with two markers: the
    images, depths and camera_params.json against the JAX package, and
    the written PNGs by decoded pixels."""
    body, lid = open_box()
    m = concatenate([body, lid])
    marks = [(np.array([0.0, -0.25, 0.1]), (1.0, 0.0, 0.0)),
             (np.array([0.0, 0.25, 0.1]), (0.0, 1.0, 0.0))]
    got, want = _views_pair(m, tmp_path, resolution=96, markers=marks)
    cp = json.loads((tmp_path / "port" / "camera_params.json").read_text())
    _close(cp, json.loads((tmp_path / "jax" / "camera_params.json")
                          .read_text()))
    assert set(cp["front"]) == {"intrinsics", "c2w", "resolution"}
    for name in got:
        gm = np.isfinite(got[name]["depth"])
        wm = np.isfinite(want[name]["depth"])
        for tag in ("", "_marked"):
            f = f"view_{name}{tag}.png"
            pix = read_png_rgb(str(tmp_path / "port" / f)).astype(int)
            jpix = np.asarray(Image.open(tmp_path / "jax" / f)).astype(int)
            assert pix.shape == jpix.shape == (96, 96, 3)
            assert_images_agree(pix, jpix, gm, wm, atol=1)
    assert (got["front"]["marked"] != got["front"]["clean"]).any()


def test_render_view_reports_dropped_triangles(capsys):
    """render_view keeps the JAX default capacity (1024) and its pixels,
    and says on stderr when the binning drops triangles: at 48 px the
    open box's 1,068 triangles fall into a few tiles, up to 930 in one."""
    from robosimgs_tpu.render.mesh_raster import MeshRasterConfig as JCfg
    from robosimgs_tpu_torch.render.mesh_raster import MeshRasterConfig

    body, lid = open_box()
    m = concatenate([body, lid])
    cam = views.view_camera(m, views.VIEW_DIRECTIONS["front"], 48,
                            device="cpu")
    jm = to_jax_mesh(m)
    jcam = jviews.view_camera(jm, jviews.VIEW_DIRECTIONS["front"], 48)
    for cap in (None, 256):
        kw = {} if cap is None else {"mesh_cfg": MeshRasterConfig(
            tile_capacity=cap)}
        jkw = {} if cap is None else {"mesh_cfg": JCfg(tile_capacity=cap)}
        img, stats = views.render_view(m, cam, return_stats=True, **kw)
        err = capsys.readouterr().err
        np.testing.assert_allclose(img, jviews.render_view(jm, jcam, **jkw),
                                   atol=1e-5)
        if cap is None:
            assert int(stats.overflowed_tiles) == 0 and err == ""
        else:
            assert int(stats.overflowed_tiles) > 0
            assert "overflowed tiles" in err and "mesh_demand" in err


# -- the three CLIs --------------------------------------------------------

SPEC = {
    "caption": "a cardboard box with an open lid on a white background",
    "responses": [
        ["list the 3 most likely materials",
         '{"1": "rigid: plant fiber", "2": "rigid: wood", '
         '"3": "deformable: leather"}'],
        ["Refine them",
         '{"density": 680, "youngs_modulus": 2.4, "poisson_ratio": 0.25}'],
    ],
    "preferences": {"a photo of plant fiber material": 2.0,
                    "a photo of wood material": 1.0},
}


@pytest.mark.parametrize("args", [["--scripted"], ["--material", "rubber",
                                                   "--method", "pbd"]],
                         ids=["scripted", "material_pbd"])
def test_cli_estimate_physics_matches_jax(tmp_path, args):
    """Both CLIs on the same Pillow-written RGBA PNG (the port reads it
    with its own decoder)."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (40, 56, 4), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "object.png")
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(SPEC))
    if args == ["--scripted"]:
        args = ["--scripted", str(spec)]
    outs = []
    for tag, main in (("port", cli_physics.main), ("jax", jcli_physics.main)):
        main([str(tmp_path / "object.png"), *args,
              "--output", str(tmp_path / f"{tag}.json")])
        outs.append(json.loads((tmp_path / f"{tag}.json").read_text()))
    assert outs[0] == outs[1]
    assert outs[0]["method"] in ("mpm", "pbd")


def test_cli_estimate_physics_jpeg_exits(tmp_path):
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "o.jpg")
    with pytest.raises(SystemExit, match="Only PNG input is read"):
        cli_physics.main([str(tmp_path / "o.jpg")])


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """An `<input>_output` tree the pipeline wrote from the open box."""
    root = tmp_path_factory.mktemp("artic")
    body, lid = open_box()
    pipeline.ArticulationPipeline(lid, body, device="cpu").generate(
        str(root / "urdf"))
    return root


def test_cli_visualize_parts_matches_jax(generated, tmp_path, capsys):
    out, jout = tmp_path / "port.png", tmp_path / "jax.png"
    cli_visualize.main([str(generated), "--out", str(out), "--resolution",
                        "64", "--device", "cpu"])
    printed = capsys.readouterr().out
    jcli_visualize.main([str(generated), "--out", str(jout), "--resolution",
                         "64"])
    jprinted = capsys.readouterr().out
    assert printed.replace(str(out), "X") == jprinted.replace(str(jout), "X")
    pix = read_png_rgb(str(out)).astype(int)
    jpix = np.asarray(Image.open(jout)).astype(int)
    assert pix.shape == jpix.shape == (64, 192, 3)
    # the parts and the axis on a white ground: a pixel differs by more
    # than one step only where an edge pixel flips coverage
    off = (np.abs(pix - jpix) > 1).any(-1)
    assert off.mean() <= MAX_FLIP_SHARE, off.mean()


def test_cli_validate_urdf_matches_jax(generated, tmp_path, capsys):
    urdf = str(generated / "urdf" / "articulated_object.urdf")
    out, jout = tmp_path / "port.png", tmp_path / "jax.png"
    cli_validate.main([urdf, "--render", str(out), "--steps", "3",
                       "--resolution", "48", "--device", "cpu", "--pybullet"])
    printed = capsys.readouterr().out
    jcli_validate.main([urdf, "--render", str(jout), "--steps", "3",
                        "--resolution", "48", "--pybullet"])
    jprinted = capsys.readouterr().out
    assert printed.replace(str(out), "X") == jprinted.replace(str(jout), "X")
    assert "kinematic validation: OK" in printed
    pix = read_png_rgb(str(out)).astype(int)
    jpix = np.asarray(Image.open(jout)).astype(int)
    assert pix.shape == jpix.shape == (48, 144, 3)
    off = (np.abs(pix - jpix) > 1).any(-1)
    assert off.mean() <= MAX_FLIP_SHARE, off.mean()


def test_clis_default_to_cuda():
    assert cli_visualize.build_parser().parse_args(["d"]).device == "cuda"
    assert cli_validate.build_parser().parse_args(["u"]).device == "cuda"
