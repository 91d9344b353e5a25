"""The plain reference against brute-force loops, and the needed-work
counter on hand-built scenes."""

import math

import numpy as np
import torch

from portbench import scenes, work
from portbench.reference import mesh, splats

RC = {"tile_size": 16, "radius_factor": 3.0, "alpha_clamp": 0.99,
      "alpha_min": 1 / 255, "transmittance_min": 1e-4, "blur": 0.3,
      "near": 0.01}


def _brute(proj, width, height, limit=None):
    """Pixel by pixel, splat by splat in depth order: the published
    front-to-back loop, in float64."""
    order = sorted(range(proj["uv"].shape[0]),
                   key=lambda i: (float(proj["depth"][i]), i))
    uv, con = proj["uv"].double(), proj["conic"].double()
    op, col = proj["opacity"].double(), proj["colour"].double()
    r = proj["radius"]
    ts = RC["tile_size"]
    rgb = np.zeros((height, width, 3))
    acc = np.zeros((height, width))
    pairs = np.zeros((height, width), np.int64)
    tiles_x, tiles_y = -(-width // ts), -(-height // ts)
    for y in range(height):
        for x in range(width):
            t = 1.0
            for i in order:
                if not bool(proj["valid"][i]) or float(r[i]) <= 0:
                    continue
                tx0 = min(max(math.floor((uv[i, 0] - r[i]) / ts), 0), tiles_x - 1)
                tx1 = min(max(math.floor((uv[i, 0] + r[i]) / ts), 0), tiles_x - 1)
                ty0 = min(max(math.floor((uv[i, 1] - r[i]) / ts), 0), tiles_y - 1)
                ty1 = min(max(math.floor((uv[i, 1] + r[i]) / ts), 0), tiles_y - 1)
                if not (tx0 <= x // ts <= tx1 and ty0 <= y // ts <= ty1):
                    continue
                dx, dy = x - float(uv[i, 0]), y - float(uv[i, 1])
                q = 0.5 * (float(con[i, 0]) * dx * dx + float(con[i, 2]) * dy * dy) \
                    + float(con[i, 1]) * dx * dy
                a = min(RC["alpha_clamp"], float(op[i]) * math.exp(-q))
                if a < RC["alpha_min"] or q < 0:
                    continue
                if limit is not None and float(proj["depth"][i]) > float(limit[y, x]):
                    continue
                if t * (1 - a) < RC["transmittance_min"]:
                    break
                rgb[y, x] += a * t * col[i].numpy()
                acc[y, x] += a * t
                pairs[y, x] += 1
                t *= 1 - a
    return rgb, acc, pairs


def _scene(n, seed, extent=0.6):
    p = scenes.random_gaussians(seed, n, 1, extent, "cpu")
    p["log_scales"] = p["log_scales"] + torch.linspace(0, 1.5, n)[:, None]
    return p


def test_composite_matches_the_pixel_loop():
    p = _scene(60, 3)
    cam = splats.camera_tensors(scenes.look_at([2.5, 0.3, 0.4], [0, 0, 0],
                                               [0, 0, 1], 50.0, 40, 24),
                                "cpu")
    proj = splats.project(p, cam, RC)
    out = splats.composite(proj, 40, 24, RC, count=True, chunk=16,
                           tile_block=2)
    rgb, acc, pairs = _brute(proj, 40, 24)
    assert np.abs(out["rgb"].numpy() - rgb).max() < 1e-5
    assert np.abs(out["alpha"].numpy() - acc).max() < 1e-5
    assert (out["pairs"].numpy() == pairs).all()


def test_composite_depth_limit_matches_the_pixel_loop():
    p = _scene(60, 4)
    cam = splats.camera_tensors(scenes.look_at([2.5, 0.3, 0.4], [0, 0, 0],
                                               [0, 0, 1], 50.0, 32, 20),
                                "cpu")
    proj = splats.project(p, cam, RC)
    limit = torch.full((20, 32), 2.5)
    limit[:, :16] = 2.0
    out = splats.composite(proj, 32, 20, RC, depth_limit=limit, chunk=8)
    rgb, _, _ = _brute(proj, 32, 20, limit)
    assert np.abs(out["rgb"].numpy() - rgb).max() < 1e-5


def test_pair_count_on_a_saturated_stack():
    # 40 near-opaque splats on one spot: each pixel keeps splats until
    # T (1 - a) < 1e-4: the middle pixels two (alpha 0.982: T 0.018, then
    # 3.2e-4, then under 1e-4), the faint rim all 40; entries count the
    # splats some pixel of a tile keeps
    n = 40
    p = scenes.random_gaussians(1, n, 0, 1.0, "cpu")
    p["means"] = torch.zeros((n, 3))
    p["means"][:, 0] = torch.linspace(-0.01, 0.01, n)
    p["log_scales"] = torch.full((n, 3), math.log(0.4))
    p["logit_opacities"] = torch.full((n,), 4.0)
    p["quats"] = torch.tensor([[1.0, 0, 0, 0]]).repeat(n, 1)
    cam = splats.camera_tensors(scenes.look_at([2.5, 0, 0], [0, 0, 0],
                                               [0, 0, 1], 45.0, 32, 32),
                                "cpu")
    proj = splats.project(p, cam, RC)
    out = splats.composite(proj, 32, 32, RC, count=True)
    centre = out["pairs"][14:18, 14:18]
    assert int(centre.min()) == 2 and int(centre.max()) <= 3
    assert int(out["pairs"].max()) == n
    assert int(out["entries"].max()) <= n
    _, _, pairs = _brute(proj, 32, 32)
    assert (out["pairs"].numpy() == pairs).all()
    ops, nbytes = work.composite_fwd(int(out["pairs"].sum()),
                                     int(out["entries"].sum()), 32 * 32,
                                     False)
    assert ops == int(out["pairs"].sum()) * work.FWD_PAIR
    assert nbytes == int(out["entries"].sum()) * 64 + 32 * 32 * 36


def test_pair_count_on_a_sparse_view():
    # three small splats far apart: each pixel keeps only the splats whose
    # alpha reaches 1/255 there, and no pair where none does
    p = scenes.random_gaussians(2, 3, 0, 1.0, "cpu")
    p["means"] = torch.tensor([[0.0, -0.5, 0.3], [0.0, 0.0, 0.0],
                               [0.0, 0.5, -0.3]])
    p["log_scales"] = torch.full((3, 3), math.log(0.02))
    p["logit_opacities"] = torch.zeros(3)
    p["quats"] = torch.tensor([[1.0, 0, 0, 0]]).repeat(3, 1)
    cam = splats.camera_tensors(scenes.look_at([2.5, 0, 0], [0, 0, 0],
                                               [0, 0, 1], 60.0, 64, 48),
                                "cpu")
    proj = splats.project(p, cam, RC)
    out = splats.composite(proj, 64, 48, RC, count=True)
    _, _, pairs = _brute(proj, 64, 48)
    assert (out["pairs"].numpy() == pairs).all()
    assert 0 < int(out["pairs"].sum()) < 64 * 48 // 4
    assert int(out["entries"].sum()) >= 3
    need = work.least_seconds(*work.composite_fwd(
        int(out["pairs"].sum()), int(out["entries"].sum()), 64 * 48, False))
    # so sparse a view is bound by its bytes, not its operations
    assert need == pytest_approx(64 * 48 * 36 + int(out["entries"].sum())
                                 * 64, work.PEAK_BYTES_PER_S)


def pytest_approx(nbytes, rate):
    return nbytes / rate


def test_mesh_raster_matches_the_pixel_loop():
    box = scenes.grid_box_mesh((0.3, 0.2, 0.1), 2, (0.8, 0.6, 0.4), seed=0)
    cam = splats.camera_tensors(scenes.look_at([1.5, 0.7, 0.9], [0, 0, 0],
                                               [0, 0, 1], 45.0, 40, 30),
                                "cpu")
    out = mesh.raster(box["vertices"], box["faces"], box["colors"], cam,
                      0.01, "cpu")
    v = torch.as_tensor(box["vertices"]).double()
    p = v @ cam["R"].double().T + cam["t"].double()
    u = cam["fx"] * p[:, 0] / p[:, 2] + cam["cx"] - 0.5
    w_ = cam["fy"] * p[:, 1] / p[:, 2] + cam["cy"] - 0.5
    depth = np.full((30, 40), np.inf)
    for f in box["faces"]:
        a, b, c = (np.array([float(u[i]), float(w_[i])]) for i in f)
        area = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        if abs(area) < 1e-12:
            continue
        for y in range(30):
            for x in range(40):
                wa = ((c[0] - b[0]) * (y - b[1]) - (c[1] - b[1]) * (x - b[0])) / area
                wb = ((a[0] - c[0]) * (y - c[1]) - (a[1] - c[1]) * (x - c[0])) / area
                wc = 1 - wa - wb
                if min(wa, wb, wc) < 0:
                    continue
                z = 1 / (wa / float(p[f[0], 2]) + wb / float(p[f[1], 2])
                         + wc / float(p[f[2], 2]))
                depth[y, x] = min(depth[y, x], z)
    got = out["depth"].numpy()
    both = np.isfinite(got) & np.isfinite(depth)
    # a pixel centre on an edge may fall either side in float32
    assert (np.isfinite(got) != np.isfinite(depth)).sum() <= 2
    assert np.abs(got[both] - depth[both]).max() < 1e-5


def test_forward_kinematics_opens_the_lid_about_its_hinge():
    obj = scenes.box_object(3, {"quads": 2})
    closed = mesh.posed_links(obj, np.zeros(1), np.eye(4))
    opened = mesh.posed_links(obj, np.array([math.pi / 2]), np.eye(4))
    assert np.allclose(closed[0][0], opened[0][0])
    lid = opened[1][0]
    # the lid's points keep their distance to the hinge line (x, 0.25, 0.1)
    d0 = np.hypot(closed[1][0][:, 1] - 0.25, closed[1][0][:, 2] - 0.1)
    d1 = np.hypot(lid[:, 1] - 0.25, lid[:, 2] - 0.1)
    assert np.allclose(d0, d1, atol=1e-5)
    assert lid[:, 2].max() > closed[1][0][:, 2].max() + 0.2
