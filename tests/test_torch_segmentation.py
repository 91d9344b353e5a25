"""The port's part segmentation (robosimgs_tpu_torch/artic/segmentation.py)
against the JAX package on the CPU, and the JAX package's Segmenter tests
on the port.

The free functions take identical numpy inputs (masks, depths, labels;
each package's camera from the same look-at) and their face labels must
be equal. The Segmenter's stages run with scripted models (ScriptedMLLM,
fake mask generators and scorers), as the JAX tests run them. Rendered
masks (mask_from_part) flip on at most 0.1 % of pixels: XLA contracts the
mesh edge functions into FMAs, torch does not.
"""

import json
import os

import numpy as np
import pytest
import torch

from robosimgs_tpu.artic import render_views as jviews
from robosimgs_tpu.artic import segmentation as jseg
from robosimgs_tpu.utils import meshio as jmeshio
from robosimgs_tpu_torch.artic import render_views as views
from robosimgs_tpu_torch.artic import segmentation as seg
from robosimgs_tpu_torch.artic.mllm import ScriptedMLLM
from robosimgs_tpu_torch.render.mesh_raster import rasterize_mesh
from robosimgs_tpu_torch.tools.workloads import open_box_parts
from robosimgs_tpu_torch.utils.bake import subdivide_mesh
from robosimgs_tpu_torch.utils.meshio import Mesh, concatenate

MAX_FLIP_SHARE = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # the suite runs files in parallel workers, where torch's CPU threads
    # spin against each other
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
                        vertex_colors=m.vertex_colors)


def cameras(m: Mesh, direction, res):
    """The same look-at camera in both packages."""
    d = np.asarray(direction, np.float64)
    return (views.view_camera(m, d, res, device="cpu"),
            jviews.view_camera(to_jax_mesh(m), d, res))


def silhouette_obs(m: Mesh, part: np.ndarray, direction, res, dil):
    """One observation of fuse_multiview_labels: part A's silhouette where
    it wins the full z-buffer, dilated as the pick stage dilates; the
    port renders it and both packages read the same arrays."""
    cam, jcam = cameras(m, direction, res)
    with torch.no_grad():
        full = rasterize_mesh(torch.as_tensor(m.vertices),
                              torch.as_tensor(m.faces), cam)
        sub = m.submesh(part)
        am = rasterize_mesh(torch.as_tensor(sub.vertices),
                            torch.as_tensor(sub.faces), cam)
    depth = full["depth"].numpy()
    sil = am["mask"].numpy() & (am["depth"].numpy() <= depth + 1e-3)
    return ({"mask": seg.dilate_mask(sil, dil), "camera": cam,
             "depth": depth},
            {"mask": seg.dilate_mask(sil, dil), "camera": jcam,
             "depth": depth})


# -- the free functions on identical inputs -----------------------------------

def test_nearest_vertex_and_dilate():
    m = box_mesh()
    idx = seg.nearest_vertex(m, [0.49, 0.49, 0.19])
    assert idx == jseg.nearest_vertex(to_jax_mesh(m), [0.49, 0.49, 0.19])
    np.testing.assert_allclose(m.vertices[idx], [0.5, 0.5, 0.2])
    mask = np.zeros((32, 32), bool)
    mask[16, 16] = True
    mask[0, 3] = True
    for px in (0, 1, 5, 10):
        d = seg.dilate_mask(mask, px)
        np.testing.assert_array_equal(d, jseg.dilate_mask(mask, px))
    assert seg.dilate_mask(mask, 5).sum() > 10


@pytest.mark.parametrize("depth,mask_b", [(False, False), (True, False),
                                          (True, True)],
                         ids=["centroids", "visibility", "two_masks"])
def test_split_mesh_by_mask_matches_jax(depth, mask_b):
    m = subdivide_mesh(box_mesh((0.5, 0.5, 0.5)), 2)
    cam, jcam = cameras(m, [0.3, -1.0, 0.4], 128)
    mask = np.zeros((128, 128), bool)
    mask[:64, :] = True
    kw = {}
    if depth:
        with torch.no_grad():
            kw["depth"] = rasterize_mesh(torch.as_tensor(m.vertices),
                                         torch.as_tensor(m.faces),
                                         cam)["depth"].numpy()
    if mask_b:
        kw["mask_b"] = np.zeros((128, 128), bool)
        kw["mask_b"][56:, :] = True        # a band both masks claim
    top, bottom, hit = seg.split_mesh_by_mask(m, mask, cam, **kw)
    jtop, jbottom, jhit = jseg.split_mesh_by_mask(to_jax_mesh(m), mask, jcam,
                                                  **kw)
    np.testing.assert_array_equal(hit, jhit)
    np.testing.assert_array_equal(top.faces, jtop.faces)
    assert 0 < hit.sum() < len(hit)
    assert top.vertices[:, 2].mean() > bottom.vertices[:, 2].mean()


def test_propagate_nearest_matches_jax():
    """More than 5,000 labelled faces (the subsample) and more than one
    2,048-row chunk of unlabelled ones."""
    rng = np.random.default_rng(0)
    cent = rng.normal(size=(12_000, 3)).astype(np.float32)
    hit = cent[:, 0] > 0.1
    labeled = rng.random(12_000) < 0.6
    got = seg._propagate_nearest(cent, hit, labeled)
    np.testing.assert_array_equal(got, jseg._propagate_nearest(cent, hit,
                                                               labeled))
    assert (got[labeled] == hit[labeled]).all()
    for lab in (np.zeros(12_000, bool), np.ones(12_000, bool)):
        np.testing.assert_array_equal(seg._propagate_nearest(cent, hit, lab),
                                      hit)


def test_split_mesh_by_points_matches_jax():
    body, lid = open_box_parts(8, 5)
    m = concatenate([lid, body])
    pts = np.array([[0.0, 0.1, 0.3], [0.0, -0.25, 0.0]], np.float32)
    a, b, hit = seg.split_mesh_by_points(m, pts)
    ja, jb, jhit = jseg.split_mesh_by_points(to_jax_mesh(m), pts)
    np.testing.assert_array_equal(hit, jhit)
    np.testing.assert_array_equal(a.faces, ja.faces)
    assert a.faces.shape[0] + b.faces.shape[0] == m.faces.shape[0]


def test_fuse_multiview_labels_matches_jax_and_beats_single_view():
    """Frontality-weighted multi-view voting: with each view's mask
    dilated (the pick stage's over-claim), the single-view split
    over-assigns a band of the other part; fusing a second orthogonal
    view recovers a strictly more accurate labelling. Both packages
    label every face the same, with and without a part-B mask."""
    m = subdivide_mesh(box_mesh((0.5, 0.5, 0.5)), 3)
    gt = m.face_centroids()[:, 2] > 0.0          # part A = top half
    dil = 6
    pairs = [silhouette_obs(m, gt, d, 160, dil)
             for d in ([0.0, -1.0, 0.0], [1.0, 0.0, 0.0])]
    obs, jobs = [p[0] for p in pairs], [p[1] for p in pairs]
    _, _, hit1 = seg.split_mesh_by_mask(m, obs[0]["mask"], obs[0]["camera"],
                                        depth=obs[0]["depth"])
    hit2 = seg.fuse_multiview_labels(m, obs, dilate_px=dil)
    np.testing.assert_array_equal(
        hit2, jseg.fuse_multiview_labels(to_jax_mesh(m), jobs, dilate_px=dil))
    err1, err2 = int((hit1 != gt).sum()), int((hit2 != gt).sum())
    assert err1 > 0 and err2 <= err1 // 2, (err2, err1)
    # with part B's own mask on the first view
    not_b = ~pairs[0][0]["mask"]
    for o in (obs[0], jobs[0]):
        o["mask_b"] = not_b
    np.testing.assert_array_equal(
        seg.fuse_multiview_labels(m, obs, dilate_px=dil),
        jseg.fuse_multiview_labels(to_jax_mesh(m), jobs, dilate_px=dil))


def test_smooth_face_labels_matches_jax_and_removes_islands():
    m = subdivide_mesh(box_mesh((0.5, 0.5, 0.5)), 2)
    gt = m.face_centroids()[:, 2] > 0.0
    noisy = gt.copy()
    flip = np.random.default_rng(0).choice(len(gt), size=8, replace=False)
    noisy[flip] = ~noisy[flip]
    sm = seg.smooth_face_labels(m, noisy)
    np.testing.assert_array_equal(sm, jseg.smooth_face_labels(
        to_jax_mesh(m), noisy))
    assert (sm != gt).sum() < (noisy != gt).sum()
    assert (seg.smooth_face_labels(m, gt) == gt).all()


def test_choose_view_geometric_matches_jax():
    """The six views' depths (the port's, handed to both) and each
    package's cameras: the same scores, so the same view."""
    body, lid = open_box_parts(8, 5)
    m = concatenate([lid, body])
    vs = views.render_canonical_views(m, resolution=64, device="cpu")
    jvs = {n: {"camera": jviews.view_camera(
        to_jax_mesh(m), jviews.ALL_DIRECTIONS[n], 64), "depth": v["depth"]}
        for n, v in vs.items()}
    for seeds in ([[0.0, 0.1, 0.3], [0.0, -0.25, 0.0]],
                  [[0.2, 0.0, -0.1], [-0.24, 0.2, 0.05]]):
        sel = [{"position": s} for s in seeds]
        got = seg.Segmenter(m, device="cpu")._choose_view_geometric(vs, sel)
        want = jseg.Segmenter(to_jax_mesh(m))._choose_view_geometric(jvs, sel)
        assert got == want


def test_mask_from_part_matches_jax_and_reports_drops(capsys):
    """The default MeshRasterConfig (tile capacity 512), as in the JAX
    package: at 48 px the open box's 1,068 triangles crowd into a few
    tiles, the binning drops some, stderr says so, and the pixels stay
    the JAX package's."""
    body, lid = open_box_parts(8, 5)
    m = concatenate([lid, body])
    for res, drops in ((48, True), (160, False)):
        cam, jcam = cameras(m, [0.0, -1.0, 0.3], res)
        got = seg.mask_from_part(m, cam)
        err = capsys.readouterr().err
        want = np.asarray(jseg.mask_from_part(to_jax_mesh(m), jcam))
        assert got.dtype == bool and got.shape == (res, res)
        assert (got != want).mean() <= MAX_FLIP_SHARE
        assert ("overflowed tiles" in err) == drops, err
    empty = Mesh(vertices=np.zeros((0, 3), np.float32),
                 faces=np.zeros((0, 3), np.int32))
    assert not seg.mask_from_part(empty, cam).any()


# -- the JAX package's Segmenter tests, on the port ---------------------------

class TopHalfMaskGen:
    """Fake SAM: candidate masks are horizontal bands."""

    def generate(self, image):
        H, W = image.shape[:2]
        full = np.zeros((H, W), bool)
        full[: H // 2] = True
        small = np.zeros((H, W), bool)
        small[: H // 4] = True
        return [small, full]


def _run_both(tmp_path, mesh, seg_kw, run_kw, responses=None):
    results = []
    for tag, mod, msh in (("port", seg, mesh), ("jax", jseg,
                                                 to_jax_mesh(mesh))):
        kw = dict(seg_kw)
        if tag == "port":
            kw["device"] = "cpu"
        if responses is not None:
            kw["mllm"] = ScriptedMLLM(responses=list(responses))
        out = tmp_path / tag
        out.mkdir()
        results.append(mod.Segmenter(msh, out_dir=str(out),
                                     mask_generator=TopHalfMaskGen(),
                                     **kw).run(**run_kw))
    return results


def test_segmenter_end_to_end(tmp_path):
    m = box_mesh((0.4, 0.4, 0.4))
    got, want = _run_both(
        tmp_path, m, dict(resolution=96, mask_dilate_px=2),
        dict(points=[[0.0, -0.4, 0.35], [0.0, -0.4, -0.35]]),
        responses=[("Pick the single viewpoint", '{"view": "front"}'),
                   ("Name each part",
                    '{"RED": "box lid", "GREEN": "box body"}')])
    assert got.best_view == want.best_view == "front"
    assert got.prompts == want.prompts == {"RED": "box lid",
                                           "GREEN": "box body"}
    for color in ("RED", "GREEN"):
        assert got.parts[color].faces.shape[0] > 0
        np.testing.assert_array_equal(got.parts[color].faces,
                                      want.parts[color].faces)
        np.testing.assert_array_equal(got.masks[color], want.masks[color])
    port = tmp_path / "port"
    for f in ("selected_points.json", "clip_prompts.json",
              "camera_params.json", "part_RED.glb", "part_GREEN.glb",
              "mask_RED_front.npy", "view_front.png", "view_front_marked.png"):
        assert (port / f).exists(), f
    cp = json.loads((port / "camera_params.json").read_text())
    assert set(cp["front"]) == {"intrinsics", "c2w", "resolution"}
    for f in ("selected_points.json", "clip_prompts.json"):
        assert (json.loads((port / f).read_text())
                == json.loads((tmp_path / "jax" / f).read_text()))


def test_segmenter_resume_and_debug_grid(tmp_path):
    from robosimgs_tpu_torch.utils.imresize import read_png_rgb

    m = box_mesh((0.4, 0.4, 0.4))
    s1 = seg.Segmenter(m, out_dir=str(tmp_path),
                       mask_generator=TopHalfMaskGen(), resolution=64,
                       mask_dilate_px=1, view_names=["front"], device="cpu")
    res1 = s1.run(points=[[0.0, -0.4, 0.35], [0.0, -0.4, -0.35]],
                  part_names=["lid", "body"], best_view="front")
    grids = [f for f in os.listdir(tmp_path / "debug")
             if f.startswith("candidates_")]
    assert grids
    # the debug grid, written without Pillow: two 64 px tiles side by side
    assert read_png_rgb(str(tmp_path / "debug" / grids[0])).shape == (64, 128,
                                                                     3)
    # resume from artifacts only (new segmenter instance)
    s2 = seg.Segmenter(m, out_dir=str(tmp_path), resolution=64,
                       view_names=["front"], device="cpu")
    res2 = s2.run(points=[], resume=True)
    assert res2.best_view == "front"
    assert res2.prompts == res1.prompts
    np.testing.assert_allclose(res2.parts["RED"].vertices,
                               res1.parts["RED"].vertices, atol=1e-6)


def test_candidate_grid_matches_jax_outside_the_labels():
    """The numbered candidate grid equals the JAX package's outside each
    tile's label box (cv2.getTextSize's, as the morphology test holds
    the stamp inside it)."""
    import cv2
    rng = np.random.default_rng(0)
    img = rng.random((96, 96, 3)).astype(np.float32)
    cands = [rng.random((96, 96)) < p for p in (0.2, 0.5, 0.7, 0.9, 0.3)]
    got = seg.Segmenter(box_mesh(), device="cpu")._candidate_grid_image(
        img, cands)
    want = jseg.Segmenter(to_jax_mesh(box_mesh()))._candidate_grid_image(
        img, cands)
    assert got.shape == want.shape == (192, 384, 3)
    scale, thick = 0.5, 1
    org = (8, int(28 * scale))
    outside = np.ones(got.shape[:2], bool)
    for i in range(len(cands)):
        (w, h), base = cv2.getTextSize(f"#{i + 1}", cv2.FONT_HERSHEY_SIMPLEX,
                                       scale, thick)
        r, c = divmod(i, 4)
        outside[r * 96 + org[1] - h:r * 96 + org[1] + base + 1,
                c * 96 + org[0]:c * 96 + org[0] + w] = False
    np.testing.assert_array_equal(got[outside], want[outside])
    assert (got[~outside] != want[~outside]).any()


def test_mllm_select_candidate_contract():
    """'2' -> index 1, '0' -> None (part not visible), garbage /
    out-of-range -> 0 (top-ranked fallback)."""
    m = box_mesh((0.3, 0.3, 0.3))
    img = np.ones((32, 32, 3), np.float32)
    cands = [np.zeros((32, 32), bool) for _ in range(3)]
    for i, c in enumerate(cands):
        c[: 8 * (i + 1)] = True
    for resp, expect in [("2", 1), ("0", None), ("banana", 0),
                         ("7", 0), (" 3 \n", 2)]:
        s = seg.Segmenter(m, mllm=ScriptedMLLM(
            responses=[("select the best segmentation candidate", resp)]),
            mllm_masks=True, device="cpu")
        assert s.mllm_select_candidate(img, cands, "box lid", "top") == expect


def test_segment_part_mllm_decides():
    """With mllm_masks on, the model's pick wins over the marker-
    containment heuristic; a 'not visible' verdict falls back to it."""
    m = box_mesh((0.4, 0.4, 0.4))
    img = np.ones((40, 40, 3), np.float32)
    mllm = ScriptedMLLM(
        responses=[("select the best segmentation candidate", "2")])
    s = seg.Segmenter(m, mask_generator=TopHalfMaskGen(), mllm=mllm,
                      mllm_masks=True, mask_dilate_px=0, device="cpu")
    assert s.segment_part(img, "box lid", marker_uv=(5.0, 5.0)).sum() == 800
    assert mllm.calls and mllm.calls[-1]["n_images"] == 1
    mllm0 = ScriptedMLLM(
        responses=[("select the best segmentation candidate", "0")])
    s0 = seg.Segmenter(m, mask_generator=TopHalfMaskGen(), mllm=mllm0,
                       mllm_masks=True, mask_dilate_px=0, device="cpu")
    assert s0.segment_part(img, "box lid", marker_uv=(5.0, 5.0)).sum() == 400


def test_mllm_choose_view_joint_parses_thinking_answer():
    m = box_mesh((0.3, 0.3, 0.3))
    mllm = ScriptedMLLM(responses=[(
        "best view for segmentation",
        "THINKING: top shows overlap of lid and body; bottom separates "
        "them cleanly.\nANSWER: bottom_oblique")])
    s = seg.Segmenter(m, mllm=mllm, mllm_masks=True, device="cpu")
    vs = {"top_oblique": {"marked": np.ones((8, 8, 3), np.float32)},
          "bottom_oblique": {"marked": np.ones((8, 8, 3), np.float32)}}
    assert s.mllm_choose_view_joint(
        vs, {"RED": "box lid", "GREEN": "box body"}) == "bottom_oblique"
    assert mllm.calls[-1]["n_images"] == 2
    s2 = seg.Segmenter(m, mllm=ScriptedMLLM(
        responses=[("best view for segmentation", "ANSWER: sideways")]),
        mllm_masks=True, device="cpu")
    assert s2.mllm_choose_view_joint(vs, {"RED": "a", "GREEN": "b"}) is None


def test_segmenter_joint_cross_view_run(tmp_path):
    """Two oblique views with the model choosing view and mask jointly:
    candidates on both views, THINKING/ANSWER view choice, numbered-grid
    pick on the chosen view; the same split as the JAX package's."""
    m = box_mesh((0.4, 0.4, 0.4))
    responses = [("Name each part", '{"RED": "box lid", "GREEN": "box body"}'),
                 ("best view for segmentation",
                  "THINKING: bottom separates them.\nANSWER: bottom_oblique"),
                 ("select the best segmentation candidate", "2")]
    got, want = _run_both(
        tmp_path, m, dict(mllm_masks=True, resolution=64, mask_dilate_px=1,
                          view_names=["top_oblique", "bottom_oblique"]),
        dict(points=[[0.0, -0.4, 0.35], [0.0, -0.4, -0.35]]),
        responses=responses)
    assert got.best_view == want.best_view == "bottom_oblique"
    for color in ("RED", "GREEN"):
        assert got.parts[color].faces.shape[0] > 0
        np.testing.assert_array_equal(got.parts[color].faces,
                                      want.parts[color].faces)
    dumps = os.listdir(tmp_path / "port" / "debug")
    assert any("top_oblique" in d for d in dumps)
    assert any("bottom_oblique" in d for d in dumps)


def test_segmenter_joint_not_visible_tries_other_view(tmp_path):
    """A 'not visible' (0) verdict on the chosen view retries the other
    view before any geometric fallback."""
    m = box_mesh((0.4, 0.4, 0.4))
    picks = iter(["0", "2"])
    mllm = ScriptedMLLM(responses=[
        ("Name each part", '{"RED": "box lid", "GREEN": "box body"}'),
        ("best view for segmentation", "ANSWER: top_oblique"),
    ], default="__dyn__")
    orig_chat = mllm.chat

    def chat(prompt, images=(), seed=None):
        if "select the best segmentation candidate" in prompt:
            mllm.calls.append({"prompt": prompt, "n_images": len(images),
                               "seed": seed})
            return next(picks)
        return orig_chat(prompt, images, seed)

    mllm.chat = chat
    s = seg.Segmenter(m, out_dir=str(tmp_path),
                      mask_generator=TopHalfMaskGen(), mllm=mllm,
                      mllm_masks=True, resolution=64, mask_dilate_px=1,
                      view_names=["top_oblique", "bottom_oblique"],
                      device="cpu")
    res = s.run(points=[[0.0, -0.4, 0.35], [0.0, -0.4, -0.35]])
    assert res.best_view == "bottom_oblique"
    assert len([c for c in mllm.calls
                if "select the best segmentation" in c["prompt"]]) == 2


class RecordingScorer:
    """Records every image it scores; prefers the smaller mask."""

    def __init__(self):
        self.images = []

    def score(self, image, labels):
        self.images.append(np.asarray(image))
        return np.array([1.0 / (1 + len(self.images)), 0.0])


def test_segment_part_uses_blur_mask_prompt():
    """The scorer ranks FGVP blur-mask prompts (sharp inside the candidate,
    blurred outside), the blur the JAX package's within 1e-5."""
    m = box_mesh((0.4, 0.4, 0.4))
    image = np.random.default_rng(0).uniform(0.0, 1.0,
                                             (64, 64, 3)).astype(np.float32)
    scorers = []
    for mod, kw in ((seg, {"device": "cpu"}), (jseg, {})):
        scorers.append(RecordingScorer())
        mod.Segmenter(m if mod is seg else to_jax_mesh(m),
                      mask_generator=TopHalfMaskGen(), scorer=scorers[-1],
                      resolution=64, **kw).segment_part(image, "lid")
    assert len(scorers[0].images) == 2
    for im, jim, frac in zip(scorers[0].images, scorers[1].images,
                             (0.25, 0.5)):
        np.testing.assert_allclose(im, jim, atol=1e-5)
        cut = int(64 * frac)
        np.testing.assert_allclose(im[:cut], image[:cut], atol=1e-6)
        outside = im[cut:]
        assert not np.allclose(outside, 1.0)
        assert outside.std() < 0.5 * image[cut:].std()
    white = RecordingScorer()
    seg.Segmenter(m, mask_generator=TopHalfMaskGen(), scorer=white,
                  resolution=64, visual_prompt="white",
                  device="cpu").segment_part(image, "lid")
    np.testing.assert_allclose(white.images[0][40:], 1.0)


def test_edge_quality_and_marker_pick_match_jax():
    """The marker pick's ranking (boundary Sobel magnitude, then the
    tighter mask) on a rendered view: the same candidate in both."""
    body, lid = open_box_parts(8, 5)
    m = concatenate([lid, body])
    cam, _ = cameras(m, [0.0, -1.0, 0.3], 96)
    img = views.render_view(m, cam)
    rng = np.random.default_rng(1)
    cands = []
    for _ in range(6):
        c = np.zeros((96, 96), bool)
        y, x = rng.integers(10, 50, 2)
        c[y:y + rng.integers(20, 46), x:x + rng.integers(20, 46)] = True
        cands.append(c)
    for mask in cands:
        assert (seg.Segmenter._edge_quality(img, mask)
                == jseg.Segmenter._edge_quality(img, mask))
    s = seg.Segmenter(m, device="cpu")
    js = jseg.Segmenter(to_jax_mesh(m))
    for marker in ((40.0, 40.0), (70.0, 20.0)):
        got = s._pick_by_markers(img, cands, marker, [(5.0, 90.0)])
        want = js._pick_by_markers(img, cands, marker, [(5.0, 90.0)])
        np.testing.assert_array_equal(got, want)


def test_missing_weights_raise(monkeypatch, tmp_path):
    """No mask generator and no weights file: the Segmenter raises, as
    the JAX package does, and never falls back to another backend."""
    from robosimgs_tpu_torch.artic import masknet
    monkeypatch.setattr(masknet, "DEFAULT_WEIGHTS",
                        str(tmp_path / "absent.msgpack"))
    s = seg.Segmenter(box_mesh(), device="cpu")
    with pytest.raises(ValueError, match="no masknet weights"):
        s.generate_candidates(np.ones((16, 16, 3), np.float32))
