"""The CUDA compositing kernels against their plain torch versions, one
train step through them, the unpacked binner against the packed one,
and the diffusion policy's forward and train step, on the card.

Marked `cuda`; every test skips without a CUDA device (decided in the
fixture, never at import). On a machine with an H100, nvcc and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.core.types import Gaussians
from robosimgs_tpu_torch.render import rasterize
from robosimgs_tpu_torch.render.binning import bin_and_gather_packed
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.kernels import (BK, LT_GROUP, bwd_splits,
                                                composite_bwd,
                                                composite_bwd_plain,
                                                composite_fwd,
                                                composite_fwd_plain,
                                                footprint_misses)
from robosimgs_tpu_torch.render.project import project
from robosimgs_tpu_torch.render.tiles import num_tiles
from robosimgs_tpu_torch.tools.quadrants import (forward_diffs,
                                                 quadrant_blocks,
                                                 quadrant_diffs)
from robosimgs_tpu_torch.tools.workloads import bench_config, saturated_scene
from robosimgs_tpu_torch.train.data import Frame
from robosimgs_tpu_torch.train.trainer import TrainConfig, Trainer

pytestmark = pytest.mark.cuda

CFG = bench_config()


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(device, n=4000, w=96, h=64, eye=(4.0, 0.5, 1.2)):
    g = Gaussians.random(torch.Generator().manual_seed(0), n, sh_degree=3,
                         extent=1.5, device=device)
    cam = Camera.look_at(eye, [0, 0, 0], [0, 0, 1], 60.0, w, h, device=device)
    return g, cam


def assert_fwd_agrees(got, want):
    """nblk equal; out at >= 60 dB with at most 1e-4 of its channels off
    by more than 1e-4 (a sequential T *= 1 - alpha can flip one splat's
    T >= 1e-4 gate against the block-cumsum form); log-T within 1e-3
    where it is above -20; the group ends of log_t_groups in the processed
    blocks (the kernel writes no others), where above -20, with at most
    1e-4 of them off by more than 1e-3 (an alpha at the 1/255 cutoff kept
    on one side only moves the group ends after it by 3.9e-3)."""
    (out, tfin, nblk, ltg), (rout, rtfin, rnblk, rltg) = got, want
    assert torch.equal(nblk, rnblk)
    err = (out - rout).abs()
    mse = float((err ** 2).mean())
    assert mse == 0.0 or -10 * torch.log10(torch.tensor(mse)) >= 60.0
    assert float((err > 1e-4).float().mean()) <= 1e-4
    live = rtfin > -20
    assert float((tfin - rtfin).abs()[live].max()) <= 1e-3
    done = (torch.arange(ltg.shape[1], device=ltg.device)[None, :]
            < nblk[:, None].long() * (BK // LT_GROUP))[:, :, None]
    live = done & (rltg > -20)
    if bool(live.any()):
        off = (ltg - rltg).abs()[live] > 1e-3
        assert float(off.float().mean()) <= 1e-4


def test_kernel_matches_plain_at_bench_config(device):
    g, cam = _scene(device)
    with torch.no_grad():
        geom, feat, counts, _ = bin_and_gather_packed(
            project(g, cam, CFG), cam.width, cam.height, CFG)
        tiles_x, _ = num_tiles(cam.width, cam.height, CFG.tile_size)
        kw = dict(tiles_x=tiles_x, cfg=CFG, has_dlim=False)
        before = composite_fwd.launches
        got = composite_fwd(geom, feat, counts, None, **kw)
        torch.cuda.synchronize()
        assert composite_fwd.launches == before + 1
        assert_fwd_agrees(got, composite_fwd_plain(geom, feat, counts, None, **kw))


def test_kernel_matches_plain_with_depth_limit_and_two_images(device):
    g, cam = _scene(device)
    _, cam2 = _scene(device, eye=(-3.0, 2.5, 1.0))
    with torch.no_grad():
        blocks = [bin_and_gather_packed(project(g, c, CFG), c.width, c.height,
                                        CFG) for c in (cam, cam2)]
    geom = torch.cat([b[0] for b in blocks])
    feat = torch.cat([b[1] for b in blocks])
    counts = torch.cat([b[2] for b in blocks])
    T, P = geom.shape[0], CFG.tile_size ** 2
    gen = torch.Generator().manual_seed(1)
    dlim = (torch.rand((T, P, 1), generator=gen) * 4 + 2).to(device)
    tiles_x, _ = num_tiles(cam.width, cam.height, CFG.tile_size)
    kw = dict(tiles_x=tiles_x, cfg=CFG, n_tiles_per_image=T // 2,
              has_dlim=True)
    got = composite_fwd(geom, feat, counts, dlim, **kw)
    torch.cuda.synchronize()
    assert_fwd_agrees(got, composite_fwd_plain(geom, feat, counts, dlim, **kw))


@pytest.mark.parametrize("tile_size", [32, 12, 20, 24])
def test_kernel_matches_plain_on_other_tile_sizes(device, tile_size):
    """Tiles over 16x16 or not in whole warps run the forward as a
    cluster of fwd_bands blocks: 32x32 as 4 bands of 256 pixels, 24x24 as
    3 of 192, 20x20 as 2 of 200 (each ending in a partial warp); 12x12
    (144 pixels, a partial warp) as a cluster of one."""
    g, cam = _scene(device)
    cfg = RenderConfig(tile_size=tile_size, tile_capacity=1024)
    with torch.no_grad():
        geom, feat, counts, _ = bin_and_gather_packed(
            project(g, cam, cfg), cam.width, cam.height, cfg)
    tiles_x, _ = num_tiles(cam.width, cam.height, tile_size)
    kw = dict(tiles_x=tiles_x, cfg=cfg, has_dlim=False)
    before = composite_fwd.launches
    got = composite_fwd(geom, feat, counts, None, **kw)
    torch.cuda.synchronize()
    assert composite_fwd.launches == before + 1
    assert_fwd_agrees(got, composite_fwd_plain(geom, feat, counts, None, **kw))


@pytest.mark.parametrize("tile_size,has_dlim,n_img", [
    (32, False, 1), (32, True, 1), (24, False, 1), (32, False, 2)])
def test_fwd_cluster_equals_quadrant_tiles(device, tile_size, has_dlim,
                                           n_img):
    """The cluster instance on each tile against the forward on the tile's
    four quadrants walking every slot (tools/quadrants.py; 16x16
    quadrants run the one-block instance, 12x12 ones a cluster of one):
    out bit-equal on every pixel,
    log_t_final on the quadrants whose nblk is the tile's, log_t_groups
    on the batches both processed, each tile's nblk its quadrants'
    largest. With a depth limit, and on a 2-image batch."""
    g, cam = _scene(device, w=96, h=96)
    _, cam2 = _scene(device, w=96, h=96, eye=(-3.0, 2.5, 1.0))
    cfg = RenderConfig(tile_size=tile_size, tile_capacity=1024)
    with torch.no_grad():
        blocks = [bin_and_gather_packed(project(g, c, cfg), c.width,
                                        c.height, cfg)
                  for c in (cam, cam2)[:n_img]]
    geom = torch.cat([b[0] for b in blocks])
    feat = torch.cat([b[1] for b in blocks])
    counts = torch.cat([b[2] for b in blocks])
    T, P = geom.shape[0], tile_size ** 2
    dlim = None
    if has_dlim:
        dlim = (torch.rand((T, P, 1), generator=torch.Generator()
                           .manual_seed(4)) * 4 + 2).to(device)
    kw = dict(tiles_x=num_tiles(96, 96, tile_size)[0], cfg=cfg,
              n_tiles_per_image=T // n_img if n_img > 1 else 0,
              has_dlim=has_dlim)
    full = composite_fwd(geom, feat, counts, dlim, **kw)
    *half_in, kw_half = quadrant_blocks(geom, feat, counts, dlim, **kw)
    half = composite_fwd(*half_in, **kw_half, skip="none")
    torch.cuda.synchronize()
    d = quadrant_diffs(full, half, **kw)
    assert d["nblk_over"] == 0
    assert d["tiles_equal"] > 0
    assert (d["out"], d["log_t_final"], d["log_t_groups"]) == (0.0, 0.0, 0.0)
    assert int(full[2].max()) > 1      # more than one batch: votes matter


def _cutoff_blocks(ts, tiles_x, tiles_y, K=512, seed=0):
    """Gathered (T, 8, K) blocks for ts-px tiles whose splats sit at the
    warps' footprint test's edge: means within 12 px of the tile, half
    of them thin (axis ratio up to 1e3, any orientation), and 70 % of the
    opacities set so that the splat's largest alpha over one warp-row of
    pixels (32 px of one tile row) is within 0.5 % of 1/255."""
    rng = np.random.default_rng(seed)
    T = tiles_x * tiles_y
    ox = (np.arange(T) % tiles_x * ts)[:, None]
    oy = (np.arange(T) // tiles_x * ts)[:, None]
    mx = ox + rng.uniform(-12, ts + 12, (T, K))
    my = oy + rng.uniform(-12, ts + 12, (T, K))
    thin = rng.uniform(size=(T, K)) < 0.5
    sx = np.where(thin, 10.0 ** rng.uniform(-1.0, 1.5, (T, K)),
                  rng.uniform(0.5, 8.0, (T, K)))
    sy = np.where(thin, sx * 10.0 ** rng.uniform(-3.0, 0.0, (T, K)),
                  rng.uniform(0.5, 8.0, (T, K)))
    rho = np.where(thin, rng.uniform(-0.999, 0.999, (T, K)),
                   rng.uniform(-0.5, 0.5, (T, K)))
    cxy = rho * sx * sy
    det = sx * sx * sy * sy - cxy * cxy
    a, b, c = sy * sy / det, -cxy / det, sx * sx / det
    row = oy + rng.integers(0, ts, (T, K))
    xs = ox[:, :, None] + np.arange(min(ts, 32))[None, None, :]
    dx = xs - mx[:, :, None]
    dy = (row - my)[:, :, None]
    q = (0.5 * (a[:, :, None] * dx * dx + c[:, :, None] * dy * dy)
         + b[:, :, None] * dx * dy).min(axis=2)
    op = rng.uniform(0.0, 1.0, (T, K))
    at_cut = (q < 40) & (rng.uniform(size=(T, K)) < 0.7)
    op = np.where(at_cut, np.minimum(
        np.exp(np.minimum(q, 40)) / 255.0 * rng.uniform(0.995, 1.005, (T, K)),
        0.99), op)
    geom = np.zeros((T, 8, K), np.float32)
    for i, v in enumerate((mx, my, a, b, c, op)):
        geom[:, i] = v
    geom[:, 6] = np.sort(rng.uniform(1.0, 5.0, (T, K)), axis=1)
    feat = rng.uniform(0, 1, (T, 8, K)).astype(np.float32)
    counts = rng.integers(K // 2, K + 1, T).astype(np.int32)
    return geom, feat, counts


@pytest.mark.parametrize("tile_size,tiles_x,tiles_y,grain", [
    (32, 3, 2, "warp"), (32, 9, 8, "band"), (24, 3, 2, "warp"),
    (24, 12, 8, "band"), (20, 3, 2, "warp")])
def test_fwd_cluster_equals_quadrants_at_the_cutoff(device, tile_size,
                                                    tiles_x, tiles_y, grain):
    """Splats at the footprint test's edge (thin conics, alphas within
    0.5 % of 1/255 on a warp's row): the cluster instance, skipping what
    its test rejects at `grain` (each warp for itself, or each band),
    bit for bit against the forward on each tile's quadrants walking
    every slot (16x16 quadrants run the one-block instance, 12x12 and
    10x10 ones a cluster of one with skip "none"), and against the plain
    version; the test's torch mirror skips slots."""
    cfg = RenderConfig(tile_size=tile_size, tile_capacity=512)
    geom, feat, counts = (torch.from_numpy(x).to(device) for x in
                          _cutoff_blocks(tile_size, tiles_x, tiles_y))
    kw = dict(tiles_x=tiles_x, cfg=cfg, has_dlim=False)
    full = composite_fwd(geom, feat, counts, None, **kw, skip=grain)
    *half_in, kw_half = quadrant_blocks(geom, feat, counts, None, **kw)
    half = composite_fwd(*half_in, **kw_half, skip="none")
    torch.cuda.synchronize()
    d = quadrant_diffs(full, half, **kw)
    assert d["nblk_over"] == 0
    assert (d["out"], d["log_t_final"], d["log_t_groups"]) == (0.0, 0.0, 0.0)
    assert_fwd_agrees(full, composite_fwd_plain(geom, feat, counts, None,
                                                **kw))
    assert float(footprint_misses(geom, tiles_x=tiles_x, cfg=cfg,
                                  grain=grain).float().mean()) > 0.2


@pytest.mark.parametrize("tile_size,grain", [
    (32, "warp"), (32, "band"), (24, "warp"), (24, "band"), (20, "warp"),
    (20, "band"), (12, "warp"), (12, "band")])
def test_fwd_skip_keeps_the_bits(device, tile_size, grain):
    """Each skip grain of the cluster instance against the same instance
    walking every slot (skip "none"), on splats at the footprint test's
    edge: every output bit for bit (20x20 bands and 12x12 tiles end in a
    partial warp), and the kernel's pair counts: every processed pair
    walked without a skip, some skipped with one, the processed pairs
    those of the blocks nblk covers."""
    cfg = RenderConfig(tile_size=tile_size, tile_capacity=512)
    geom, feat, counts = (torch.from_numpy(x).to(device) for x in
                          _cutoff_blocks(tile_size, 3, 2, seed=1))
    kw = dict(tiles_x=3, cfg=cfg, has_dlim=False)
    pairs_all = torch.zeros(2, dtype=torch.int64, device=device)
    pairs = torch.zeros(2, dtype=torch.int64, device=device)
    every = composite_fwd(geom, feat, counts, None, **kw, skip="none",
                          pairs=pairs_all)
    got = composite_fwd(geom, feat, counts, None, **kw, skip=grain,
                        pairs=pairs)
    torch.cuda.synchronize()
    assert all(v == 0.0 for v in forward_diffs(got, every).values())
    processed = int((torch.minimum(every[2].long() * BK, counts.long())
                     ).sum()) * tile_size ** 2
    assert pairs_all.tolist() == [processed, processed]
    assert int(pairs[1]) == processed
    assert 0 < int(pairs[0]) < processed


@pytest.mark.parametrize("tile_size,has_dlim", [(32, False), (32, True),
                                                (12, False), (24, True)])
def test_bwd_kernel_matches_plain_on_other_tile_sizes(device, tile_size,
                                                      has_dlim):
    """32x32 tiles (1024 pixels, four a thread) and ragged ones (144 and
    576 pixels, partial warps) through the backward's second instance,
    on the forward kernel's residuals, with and without a depth limit."""
    g, cam = _scene(device)
    cfg = RenderConfig(tile_size=tile_size, tile_capacity=1024)
    with torch.no_grad():
        geom, feat, counts, _ = bin_and_gather_packed(
            project(g, cam, cfg), cam.width, cam.height, cfg)
    tiles_x, _ = num_tiles(cam.width, cam.height, tile_size)
    P = tile_size * tile_size
    dlim = None
    if has_dlim:
        dlim = (torch.rand((geom.shape[0], P, 1),
                           generator=torch.Generator().manual_seed(2))
                * 4.0 + 2.0).to(device)
    kw = dict(tiles_x=tiles_x, cfg=cfg, has_dlim=has_dlim)
    out, tfin, nblk, ltg = composite_fwd(geom, feat, counts, dlim, **kw)
    gout = torch.randn(out.shape, generator=torch.Generator().manual_seed(9))
    gout = gout.to(device)
    before = composite_bwd.launches
    got = composite_bwd(geom, feat, counts, dlim, gout, tfin, nblk, ltg, **kw)
    torch.cuda.synchronize()
    assert composite_bwd.launches == before + 1
    assert_bwd_agrees(got, composite_bwd_plain(geom, feat, counts, dlim, gout,
                                               tfin, nblk, ltg, **kw))
    assert float(got[0][:, :6].abs().max()) > 0.0


def test_rasterize_on_card_matches_cpu_reference(device):
    g, cam = _scene(device, n=1500, w=64, h=48)
    cfg = RenderConfig(tile_capacity=512)
    before = composite_fwd.launches
    with torch.no_grad():
        out = rasterize(g, cam, cfg)              # "auto" = tiled on cuda
        ref = rasterize(g.to("cpu"), cam.to("cpu"), cfg, impl="reference")
    assert composite_fwd.launches == before + 1
    for k in ("rgb", "alpha", "depth"):
        err = (out[k].cpu() - ref[k]).abs()
        assert float(err.max()) <= 2e-3, k      # at most one gate flip
        assert float((err > 1e-4).float().mean()) <= 1e-3, k


def assert_bwd_agrees(got, want):
    """Per row: at most 1e-4 of the slots off by more than 1e-4 + 1e-3
    |plain| (a log-T gate flip against the plain version's cumsum order
    moves one pixel's share of a slot)."""
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        off = (a - b).abs() > 1e-4 + 1e-3 * b.abs()
        assert float(off.float().mean(dim=(0, 2)).max()) <= 1e-4


@pytest.mark.parametrize("absgrad", [False, True])
def test_bwd_kernel_matches_plain_at_bench_config(device, absgrad):
    cfg = RenderConfig(**{**CFG.__dict__, "absgrad": absgrad})
    g, cam = _scene(device)
    with torch.no_grad():
        probe = torch.zeros((g.capacity, 2), device=device) if absgrad else None
        geom, feat, counts, _ = bin_and_gather_packed(
            project(g, cam, cfg, abs_probe=probe), cam.width, cam.height, cfg)
    tiles_x, _ = num_tiles(cam.width, cam.height, cfg.tile_size)
    kw = dict(tiles_x=tiles_x, cfg=cfg, has_dlim=False)
    out, tfin, nblk, ltg = composite_fwd(geom, feat, counts, None, **kw)
    gout = torch.randn(out.shape, generator=torch.Generator().manual_seed(4))
    gout = gout.to(device)
    before = composite_bwd.launches
    got = composite_bwd(geom, feat, counts, None, gout, tfin, nblk, ltg, **kw)
    torch.cuda.synchronize()
    assert composite_bwd.launches == before + 1
    assert_bwd_agrees(got, composite_bwd_plain(geom, feat, counts, None, gout,
                                               tfin, nblk, ltg, **kw))


def _sparse_scene(device):
    """60 splats over a 256x256 view: most tiles empty or nearly so."""
    g, cam = _scene(device, n=60, w=256, h=256)
    return g, cam, CFG


@pytest.mark.parametrize("make", [saturated_scene, _sparse_scene],
                         ids=["saturated", "sparse"])
def test_kernels_match_plain_where_work_is_skipped(device, make):
    g, cam, cfg = make(device)
    with torch.no_grad():
        geom, feat, counts, stats = bin_and_gather_packed(
            project(g, cam, cfg), cam.width, cam.height, cfg)
    assert int(stats.truncated_gaussians) == 0
    tiles_x, _ = num_tiles(cam.width, cam.height, cfg.tile_size)
    kw = dict(tiles_x=tiles_x, cfg=cfg, has_dlim=False)
    got = composite_fwd(geom, feat, counts, None, **kw)
    torch.cuda.synchronize()
    assert_fwd_agrees(got, composite_fwd_plain(geom, feat, counts, None, **kw))
    out, tfin, nblk, ltg = got
    gout = torch.randn(out.shape, generator=torch.Generator().manual_seed(8))
    gout = gout.to(device)
    bwd = composite_bwd(geom, feat, counts, None, gout, tfin, nblk, ltg, **kw)
    torch.cuda.synchronize()
    assert_bwd_agrees(bwd, composite_bwd_plain(geom, feat, counts, None, gout,
                                               tfin, nblk, ltg, **kw))
    assert float(bwd[0][:, :6].abs().max()) > 0.0


def _split_case(device, tile_size, has_dlim=False):
    """A 64x64 view of 20,000 splats on tile_size tiles at K = 2048: at
    32x32 four tiles, so the backward splits each across 8 blocks.
    (inputs, kw, splits)."""
    g, cam = _scene(device, n=20000, w=64, h=64)
    cfg = RenderConfig(tile_size=tile_size, tile_capacity=2048)
    with torch.no_grad():
        geom, feat, counts, _ = bin_and_gather_packed(
            project(g, cam, cfg), cam.width, cam.height, cfg)
    T, P = geom.shape[0], tile_size ** 2
    dlim = None
    if has_dlim:
        dlim = (torch.rand((T, P, 1), generator=torch.Generator()
                           .manual_seed(12)) * 4.0 + 2.0).to(device)
    kw = dict(tiles_x=num_tiles(64, 64, tile_size)[0], cfg=cfg,
              has_dlim=has_dlim)
    out, tfin, nblk, ltg = composite_fwd(geom, feat, counts, dlim, **kw)
    gout = torch.randn(out.shape, generator=torch.Generator().manual_seed(11))
    args = (geom, feat, counts, dlim, gout.to(device), tfin, nblk, ltg)
    splits = bwd_splits(T, geom.shape[2], P, torch.cuda.get_device_properties(
        device).multi_processor_count)
    return args, kw, splits


@pytest.mark.parametrize("tile_size,has_dlim", [(32, False), (32, True),
                                                (12, False), (20, True)])
def test_split_bwd_matches_plain(device, tile_size, has_dlim):
    """The split kernel (a tile's processed blocks across a cluster of
    blocks that pass each other their suffix sums) against the plain
    version: T = 4 at 32x32 and K = 2048, so 8 blocks a tile; ragged
    12x12 tiles (144 pixels) and 20x20 ones (400)."""
    args, kw, splits = _split_case(device, tile_size, has_dlim)
    nblk = args[6]
    assert splits > 1 and int(nblk.max()) > 1
    before = composite_bwd.launches
    got = composite_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert composite_bwd.launches == before + 1
    assert_bwd_agrees(got, composite_bwd_plain(*args, **kw))
    assert float(got[0][:, :6].abs().max()) > 0.0


def test_split_bwd_is_deterministic(device):
    """Two launches on the same inputs give the same bits (no atomics;
    the blocks of a tile add each other's sums in a fixed order)."""
    args, kw, splits = _split_case(device, 32)
    assert splits > 1
    first = composite_bwd(*args, **kw)
    second = composite_bwd(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_bwd_kernel_needs_log_t_groups(device):
    g, cam = _scene(device, n=500, w=32, h=32)
    with torch.no_grad():
        geom, feat, counts, _ = bin_and_gather_packed(
            project(g, cam, CFG), cam.width, cam.height, CFG)
    kw = dict(tiles_x=2, cfg=CFG, has_dlim=False)
    out, tfin, nblk, _ = composite_fwd(geom, feat, counts, None, **kw)
    with pytest.raises(ValueError, match="log_t_groups"):
        composite_bwd(geom, feat, counts, None, out, tfin, nblk, None, **kw)


def test_train_step_on_card_matches_cpu(device):
    """One tiled Trainer step on the card launches each kernel once and
    moves the Gaussians as the same step on the CPU (plain versions)."""
    g, cam = _scene(device, n=1500, w=64, h=48)
    target = torch.rand((48, 64, 3), generator=torch.Generator().manual_seed(5))
    cfg = TrainConfig(render=RenderConfig(tile_capacity=512), impl="tiled",
                      densify_from=10_000, log_every=1)
    runs = {}
    for dev in ("cpu", "cuda"):
        tr = Trainer(cfg, g.to(dev), [Frame(camera=cam.to(dev),
                                            image=target.numpy())])
        f0, b0 = composite_fwd.launches, composite_bwd.launches
        tr.run(iterations=1, progress=False)
        runs[dev] = (tr.state.gaussians.means.cpu(),
                     composite_fwd.launches - f0,
                     composite_bwd.launches - b0, tr.history[0])
    means_cpu, f_cpu, b_cpu, _ = runs["cpu"]
    means_gpu, f_gpu, b_gpu, m = runs["cuda"]
    assert (f_cpu, b_cpu) == (0, 0) and (f_gpu, b_gpu) == (1, 1)
    assert m["overflow"] == 0
    # Adam's first step moves each coordinate by lr(0) = 1.6e-4 times the
    # sign of its gradient: equal wherever that sign is not f32 noise
    diff = (means_gpu - means_cpu).abs()
    assert float(diff.max()) <= 3.3e-4
    assert float((diff > 1e-6).float().mean()) <= 1e-3


def test_graphed_steps_equal_eager_steps(device):
    """fused_steps on the card (one step captured as a CUDA graph and
    replayed) against the eager loop on the same frames: 12 steps in
    chunks of 4 and 2 around a densify round and a pool resize, with the
    exposure affine and the bilateral grid on. The Gaussians, the
    affines and every logged loss agree within the JAX fused test's
    tolerances, and the resized pool was captured anew."""
    g = Gaussians.random(torch.Generator().manual_seed(0), 600, sh_degree=3,
                         extent=1.5, capacity=4096, device=device)
    cams = [Camera.look_at(e, [0, 0, 0], [0, 0, 1], 60.0, 64, 48,
                           device=device)
            for e in ([4.0, 0.5, 1.2], [-3.0, 2.5, 1.0], [0.5, -4.0, 1.5])]
    frames = [Frame(camera=c, image=torch.rand(
        (48, 64, 3), generator=torch.Generator().manual_seed(i)).numpy())
        for i, c in enumerate(cams)]
    cfg = TrainConfig(render=RenderConfig(tile_capacity=512), impl="tiled",
                      iterations=12, log_every=1, densify_from=4,
                      densify_until=8, densify_interval=4, pool_bucket=256,
                      opacity_reset_interval=10_000, exposure=True,
                      bilateral_grid=True, bilagrid_shape=(4, 4, 3))
    runs = {}
    for fused in (0, 4):
        tr = Trainer(dataclasses.replace(cfg, fused_steps=fused), g, frames)
        tr.run(progress=False)
        torch.cuda.synchronize()
        runs[fused] = tr
    eager, graphed = runs[0], runs[4]
    assert graphed._fused_steps_fn is not None
    assert len(graphed._fused_steps_fn.capture_seconds) >= 2   # resized
    assert [h["step"] for h in graphed.history] == list(range(12))
    for h0, h1 in zip(eager.history, graphed.history):
        assert abs(h1["loss"] - h0["loss"]) <= 1e-5 * abs(h0["loss"]) + 1e-6
    for k in ("means", "logit_opacities"):
        a = getattr(graphed.state.gaussians, k).cpu()
        b = getattr(eager.state.gaussians, k).cpu()
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-5), k
    assert torch.allclose(graphed.state.exposure, eager.state.exposure,
                          rtol=1e-5, atol=1e-6)
    assert graphed.state.step == eager.state.step == 12


def test_batched_composite_launches_the_forward_once(device):
    """composite_tiled_batch of 3 cameras: one forward launch over 3 x T
    tiles, each camera's image bit for bit its composite_tiled, and one
    backward launch for its gradient."""
    from robosimgs_tpu_torch.render.tiled import (composite_tiled,
                                                  composite_tiled_batch,
                                                  stack_projected)
    g, _ = _scene(device, n=3000)
    cams = [Camera.look_at(e, [0, 0, 0], [0, 0, 1], 60.0, 96, 64,
                           device=device)
            for e in ([4.0, 0.5, 1.2], [-3.0, 2.5, 1.0], [0.5, -4.0, 1.5])]
    with torch.no_grad():
        projs = stack_projected([project(g, c, CFG) for c in cams])
        f0 = composite_fwd.launches
        out = composite_tiled_batch(projs, 96, 64, CFG)
        torch.cuda.synchronize()
        assert composite_fwd.launches == f0 + 1
        for c, cam in enumerate(cams):
            one = composite_tiled(project(g, cam, CFG), 96, 64, CFG)
            assert torch.equal(out["rgb"][c], one["rgb"]), c
    params = g.means.clone().requires_grad_(True)
    projs = stack_projected([project(g.replace(means=params), c, CFG)
                             for c in cams])
    b0 = composite_bwd.launches
    composite_tiled_batch(projs, 96, 64, CFG)["rgb"].sum().backward()
    torch.cuda.synchronize()
    assert composite_bwd.launches == b0 + 1
    assert float(params.grad.abs().max()) > 0.0


def test_unpacked_binner_equals_packed_on_card(device):
    """chip_smoke phase 14a: at the bench width with the exact cull off
    and one tier, bin_gaussians + gather_tile_features select what
    bin_and_gather_packed selects and gather the same live blocks, with
    no truncated Gaussian; composite_from_tiles launches the forward once
    and renders them bit for bit as it renders the packed blocks."""
    from robosimgs_tpu_torch.render.binning import (bin_gaussians,
                                                    gather_tile_features)
    from robosimgs_tpu_torch.render.tiled import composite_from_tiles
    from robosimgs_tpu_torch.tools.workloads import bench_scene
    g, cam, cfg = bench_scene(device)
    cfg = dataclasses.replace(cfg, exact_tile_cull=False, two_tier_split=0)
    W, H = cam.width, cam.height
    with torch.no_grad():
        proj = project(g, cam, cfg)
        sel, counts, st = bin_gaussians(proj, W, H, cfg)
        geom, feat = gather_tile_features(proj, sel, counts, cfg)
        pgeom, pfeat, pcounts, pst, psel = bin_and_gather_packed(
            proj, W, H, cfg, return_sel=True)
        live = torch.arange(sel.shape[1], device=device)[None, :] \
            < counts[:, None]
        assert torch.equal(counts, pcounts)
        assert torch.equal(sel[live], psel[live])
        assert torch.equal(geom.transpose(1, 2)[live],
                           pgeom.transpose(1, 2)[live])
        assert torch.equal(feat.transpose(1, 2)[live],
                           pfeat.transpose(1, 2)[live])
        for f in dataclasses.fields(st):
            assert int(getattr(st, f.name)) == int(getattr(pst, f.name))
        assert int(st.truncated_gaussians) == 0
        f0 = composite_fwd.launches
        img = composite_from_tiles(geom, feat, counts, W, H, cfg)
        torch.cuda.synchronize()
        assert composite_fwd.launches == f0 + 1
        pimg = composite_from_tiles(pgeom, pfeat, pcounts, W, H, cfg)
    for k in img:
        assert torch.equal(img[k], pimg[k]), k


def _box_meshes(device, n=2):
    """The rollout object's body as one box of n x n face grids, at its
    resting place in front of the splats."""
    import numpy as np

    from robosimgs_tpu_torch.tools.workloads import ROLLOUT_BASE, grid_box_mesh
    box = grid_box_mesh((0.25, 0.25, 0.1), n, (0.8, 0.6, 0.4), seed=0)
    return [tuple(torch.from_numpy(x).to(device) for x in (
        box.vertices + np.float32(ROLLOUT_BASE), box.faces, box.vertex_colors))]


def test_render_composite_on_card_matches_cpu(device):
    """Splats depth-merged with a box, 64x48: the card (the kernel) against
    the CPU path (its plain version)."""
    from robosimgs_tpu_torch.render.compose import render_composite
    from robosimgs_tpu_torch.tools.workloads import rollout_scene
    g, cams, _ = rollout_scene(device, n=1500)
    cam = cams[0].resized(64, 48)
    cfg = RenderConfig(tile_capacity=512)
    before = composite_fwd.launches
    with torch.no_grad():
        out = render_composite(g, cam, _box_meshes(device), cfg)  # tiled
        ref = render_composite(g.to("cpu"), cam.to("cpu"), _box_meshes("cpu"),
                               cfg, impl="tiled")
    assert composite_fwd.launches == before + 1
    assert bool(out["mesh_mask"].any())
    for k in ("rgb", "alpha", "splat_depth"):
        err = (out[k].cpu() - ref[k]).abs()
        assert float(err.max()) <= 2e-3, k      # at most one gate flip
        assert float((err > 1e-4).float().mean()) <= 1e-3, k


def test_rasterize_mesh_on_card_matches_cpu(device):
    from robosimgs_tpu_torch.render.mesh_raster import rasterize_mesh
    from robosimgs_tpu_torch.tools.workloads import rollout_scene
    _, cams, _ = rollout_scene(device, n=10)
    cam = cams[0].resized(160, 120)
    out = {d: rasterize_mesh(*m[:2], cam.to(d), vertex_colors=m[2])
           for d in ("cpu", "cuda") for m in _box_meshes(d, n=8)}
    card, cpu = out["cuda"], out["cpu"]
    assert int(card["stats"].overflowed_tiles) == 0
    both = card["mask"].cpu() & cpu["mask"]
    assert int((card["mask"].cpu() != cpu["mask"]).sum()) <= 0.001 * both.numel()
    assert int(both.sum()) > 1000
    torch.testing.assert_close(card["depth"].cpu()[both], cpu["depth"][both],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(card["rgb"].cpu()[both], cpu["rgb"][both],
                               rtol=1e-5, atol=1e-5)


def test_kernel_matches_plain_with_mesh_depth_limit_at_rollout_shape(device):
    """640x480, K=512 (the rollout config), with the box's z-buffer as
    the per-pixel depth limit."""
    from robosimgs_tpu_torch.render.gathered import tile_image
    from robosimgs_tpu_torch.render.mesh_raster import rasterize_mesh
    from robosimgs_tpu_torch.tools.workloads import rollout_scene
    g, cams, cfg = rollout_scene(device, n=50_000)
    cam = cams[0]
    v, f, c = _box_meshes(device, n=8)[0]
    tiles_x, tiles_y = num_tiles(cam.width, cam.height, cfg.tile_size)
    with torch.no_grad():
        depth = rasterize_mesh(v, f, cam, vertex_colors=c)["depth"]
        geom, feat, counts, stats = bin_and_gather_packed(
            project(g, cam, cfg), cam.width, cam.height, cfg)
    assert int(stats.truncated_gaussians) == 0
    assert 0.01 < float(torch.isfinite(depth).float().mean()) < 0.9
    dlim = tile_image(depth, tiles_x, tiles_y, cfg.tile_size,
                      pad_value=float("inf"))[..., None].contiguous()
    kw = dict(tiles_x=tiles_x, cfg=cfg, has_dlim=True)
    got = composite_fwd(geom, feat, counts, dlim, **kw)
    torch.cuda.synchronize()
    assert_fwd_agrees(got, composite_fwd_plain(geom, feat, counts, dlim, **kw))


@pytest.mark.parametrize("ss", [False, True], ids=["gap", "spatial_softmax"])
def test_policy_forward_and_train_step_on_card_match_cpu(device, ss):
    """The diffusion policy at its full width (96x96, two frames, one
    joint): the forward and one train step's loss, gradients and updated
    weights on the card against the CPU path, from the same weights and
    draws; TF32 is off, so both are f32."""
    import numpy as np

    from robosimgs_tpu_torch.policy.diffusion import (DiffusionPolicy,
                                                      DiffusionPolicyConfig,
                                                      NoiseSchedule)
    from robosimgs_tpu_torch.policy.trainer import (PolicyTrainConfig,
                                                    PolicyTrainer,
                                                    RolloutDataset,
                                                    policy_loss)

    pc = DiffusionPolicyConfig(action_dim=1, state_dim=1, spatial_softmax=ss)
    g = torch.Generator().manual_seed(0)
    b = 8
    images = torch.rand((b, 2, 96, 96, 3), generator=g)
    states = torch.randn((b, 2, 1), generator=g)
    actions = torch.rand((b, 16, 1), generator=g) * 2 - 1
    t = torch.randint(0, 100, (b,), generator=g)
    noise = torch.randn((b, 16, 1), generator=g)
    model = DiffusionPolicy(pc)
    out, grads = {}, {}
    for d in ("cpu", "cuda"):
        m = DiffusionPolicy(pc).to(d)
        m.load_state_dict(model.state_dict())
        args = [x.to(d) for x in (images, states, actions, t, noise)]
        with torch.no_grad():
            out[d] = m(args[0], args[1], actions.to(d), t.to(d)).cpu()
        policy_loss(m, *args, NoiseSchedule.make(pc, d)).backward()
        grads[d] = {k: p.grad.cpu() for k, p in m.named_parameters()}
    assert float((out["cuda"] - out["cpu"]).abs().max()) \
        <= 1e-4 * float(out["cpu"].abs().max())
    for k, want in grads["cpu"].items():
        assert float((grads["cuda"][k] - want).abs().max()) \
            <= 1e-3 * float(want.abs().max()), k
    # PolicyTrainer steps on the card from host batches: finite losses,
    # the weights move, the EMA follows
    rng = np.random.default_rng(0)
    ds = RolloutDataset(images=rng.uniform(size=(40, 96, 96, 3)).astype(
        np.float32), states=rng.normal(size=(40, 1)).astype(np.float32),
        actions=rng.normal(size=(40, 1)).astype(np.float32),
        episode_ends=[40])
    tr = PolicyTrainer(PolicyTrainConfig(policy=pc, warmup_steps=1,
                                         batch_size=b), ds)
    w0 = tr.model.denoiser.out.weight.detach().clone()
    tr.run(steps=3, log_every=1, progress=False)
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    assert tr.count == 3 and tr.model.denoiser.out.weight.is_cuda
    assert not torch.equal(tr.model.denoiser.out.weight, w0)
    assert not torch.equal(tr.ema_model.denoiser.out.weight, w0)
