#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (robosimgs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on a fault (nothing is caught):
  1. device  — card name, count, nvidia-smi name and power limit
  2. build   — nvcc builds csrc/composite_fwd.cu and csrc/composite_bwd.cu,
               one process each, together (seconds, ptxas report)
  3. kernel  — each kernel against its plain version on the card at the
               bench workload (100k Gaussians, SH 3, 256x256, K=384,
               M=10, bbox 12, two-tier 4/0.15): without a depth limit,
               with a random one over a 2-camera batch, and (backward)
               with absgrad; both on a saturated stack (256 near-opaque
               splats on one corner of four tiles) and on a sparse view
               (60 splats over 256x256), where the backward skips work;
               the forward on 32x32 tiles (its cluster instance, four
               blocks a tile);
               the backward on 32x32 tiles (its split kernel) on
               those residuals and at the bench K=384 (T=64) with and
               without a depth limit, and on ragged 12x12 tiles;
               the backward on the forward kernel's residuals, with the
               count of pixels whose weight gate a linear T (the
               forward's) and a log T (the backward's) decide
               differently
  4. main    — rasterize(impl="tiled") at that width through the forward
               kernel: zero truncation, finite, >= 60 dB against the
               lossless K=5120 render, a small scene against the CPU
               reference; then the training main path: Trainer steps
               at that width (zero target, L1+SSIM, per-group Adam) with
               one launch of each kernel per step, zero truncation and a
               finite loss, and a small scene's per-Gaussian gradients
               on the card against the CPU path (plain versions)
  5. entry   — the render CLI on a saved .ply: two 640x480 orbit PNGs;
               each kernel against its plain version on those two orbit
               views' bins (default RenderConfig, K=1024, 40x30 tiles);
               then cli.train --synthetic 20000 --iterations 600
               --capacity 65536 (24 cameras, 256x256, one densify round
               and a pool resize at step 500): PSNR rises, scene.ply
               renders through the CLI
  6. times   — kernels, plain versions (CUDA events) and their bounds
               from this run's shapes and counts (the backward's counts
               only the pairs a pixel enters unsaturated); the render and
               the
               train step (CUDA events and host wall), the train step's
               device idle share and top kernels (profiler), and its
               Gaussians/s (bench.py's metric, here on the card)
  7. rollout — the rollout path at full width (tools/workloads.py: 200k
               splats, SH 2, four 640x480 cameras, K=512, M=64, bbox 84,
               two-tier split 12, its spill tier sized to the draw; a
               box-with-hinged-lid URDF of 24,576 triangles in front of
               the splats, posed by a trajectory file): zero truncated splats
               on every camera; cli.render_rollout --autotune writes 8 x 4
               PNGs, its mesh tile capacity sized from the measured
               triangle demand; render_rollout in process launches the
               forward kernel once per (step, camera), its frames agree
               with the CLI's at >= 60 dB and, at step 0, reach 60 dB
               against K=8192; no truncated triangle or overflowed mesh
               tile (at the workload's mesh capacity, 2048, and at the
               CLI's) on any step, camera or link; the kernel against its
               plain version with a mesh depth limit; the card against
               the CPU path on a small scene; the frame's time, idle share
               and stage split, and the kernel's time and bound at this
               shape
  8. policy  — the diffusion policy at DiffusionPolicyConfig's defaults
               (96x96, two frames, horizon 16, embed 256, hidden 512, 4
               FiLM blocks, 100 diffusion steps; one joint): a dataset of
               open-close episodes at four speeds rendered by
               render_rollout through one 96x96 camera (the rollout
               scene and object, capacities autotuned); PolicyTrainer at
               batch 64 (the loss falls; step time by CUDA events and host
               wall, kernels per step and idle share, the host batch's
               gather and copy, and each layer's time); forward and
               gradients on the card against the CPU path in both encoder
               heads; predict at B=1 with 16 and 100 steps; run_closed_loop
               for 8 steps with an ensembling ActionChunker, exactly 9
               forward kernel launches, the kernel against its plain
               version on an observation, its time and bound at that
               shape; cli.render_rollout at 640x480 -> cli.train_policy ->
               policy.pt reloaded and predicting
  9. artic   — the articulation toolchain at full width (the open box of
               tools/workloads.py: a 100-quad body and a 65-quad lid,
               87,342 vertices, 170,700 triangles, the lid opened 60
               degrees): HingeDetector on the card and on the CPU (contact
               counts and flips, the axis along x and the position on the
               edge); the six canonical 800x800 views with markers (ms, the
               triangle stats and mesh_demand per view; the front view
               against the CPU path); ArticulationPipeline with a scripted
               MLLM and a URDF that validates; the bake of six unshaded
               views back to the vertex colours; depth_map_from_points on
               1M surface samples against the CPU and the z-buffer; the
               estimate_physics, visualize_parts and validate_urdf CLIs on
               those outputs. No compositing kernel runs on this path.
 10. segment — mesh to URDF on the same open box as one mesh (the lid's
               50,700 triangles first), seeded at the lid vertex nearest
               its centroid and the body vertex nearest (0, -0.25, 0):
               cli.articulate with the geometric split, then with the
               mask model (--mask-backend masknet --fusion-views 3) and
               its URDF through cli.validate_urdf; every part non-empty,
               the lid's face count and face accuracy against the truth,
               the hinge's axis and its distance from the edge, each
               Segmenter stage's host wall, the triangles every render
               drops; the mask model's forward on the chosen view's
               prompt batch on the card against the CPU (logits within
               1e-4, thresholded pixels within 0.1 %), its time, kernels
               and idle share, generate's; train_masknet (150 steps at
               64 px, batch 8, 24 scenes) on the card. No compositing
               kernel runs on this path either.
 11. leftovers — the bilateral grid at 1920x1080 (32 blocks) and 256x256,
               card against CPU, timed; exposure and the grid in
               training on cli.train's synthetic scene (20,000
               Gaussians, 24 cameras, 256x256: per-frame tints / a
               vignette, 300 steps at fused_steps 10 and lr 5e-3;
               post-correction PSNR over each frame's last visit above
               the feature-off run's for the tints, and for the
               vignette at lr 1e-3; the grid at lr 5e-3 reported at 300
               and 600 steps), then cli.train --exposure
               --bilateral-grid; the bench train step eager against its
               CUDA graph's replay (host wall, CUDA events; in one
               profiled window its wall, the device's busy union and
               kernels a step; capture time, memory) and fused_steps 10
               against 0 across a
               densify round, an opacity reset and a pool resize;
               composite_tiled_batch at the rollout workload with the
               mesh depth limit: one forward launch for 4 x 1,200 tiles,
               the images against four composite_tiled calls, the kernel
               against its plain version, the gradient against the
               per-camera sum, times and bound; on 32x32 tiles at the
               capacities recommend_capacities gives the bench view
               the nblk distribution, both kernels against their plain
               versions (the backward's split kernel without and with a
               depth limit and with absgrad, two launches bit-equal),
               the forward's cluster instance bit-equal to the forward
               on each tile's 16x16 quadrants and to its own walk of
               every slot (without and with a depth limit), the pairs
               its footprint test skips (the kernel's count),
               their times and bounds, Trainer steps there, the same
               steps as a CUDA graph bit-equal to them, the step's device
               time by operation, and a small scene's gradients on the
               card against the CPU
 12. multi-device — parallel/ at world size 1 over NCCL in this process
               (mesh (1, 1), the bench workload): the DP step and the
               gaussian-sharded step (all_gather, ring) against
               make_train_step (loss and gradients within 1e-6 of the
               largest), one launch of each kernel a step, ms / host wall
               / kernels a step; render_rollout(camera_mesh=) on the
               rollout workload (2 steps) bit-equal to the unsharded
               frames; cli.render_rollout --shard-cameras on one rank
               (its own NCCL group) writing the unsharded CLI's PNGs;
               then two ranks over gloo on the one card
               (tools/dist_run.py): the DP step over 2 cameras against
               world 1, the ring over 2 shards of 50k at a lossless
               single-tier K (counts bit-equal to the whole set's binning,
               nothing truncated or overflowed; both kernels against their
               plain versions on the merged blocks), the ring step against
               the all_gather step, the camera-sharded rollout bit-equal,
               the bytes staged through the host. No scaling is measured
 13. feasibility — the JAX package's 3M-Gaussian config
               (scripts/feasibility_3m.py; tools/workloads.py: 3M
               Gaussians, SH 3, 512x512, 32-px tiles, K=2048, M=16, bbox
               20): K=2048 against K=4096 above 60 dB, no truncated
               Gaussian, both kernels against their plain versions with
               their times and bounds and the nblk distribution, the
               forward bit-equal to the forward on 16x16 quadrants and
               to its walk of every slot, the pairs it skips, 5
               Trainer steps (one launch of each kernel a step, finite
               losses), the step's ms, peak memory and device time by
               operation
 14. measure — the unpacked binner (bin_gaussians + gather_tile_features)
               at the bench width against bin_and_gather_packed with the
               exact cull off and one tier: equal selection and blocks,
               one forward launch and a bit-equal render through
               composite_from_tiles, zero truncation, gradients through
               Composite within 1e-5, the forward against its plain
               version on those blocks; tools/profile_stages.py at the
               bench config and the 3M config (each stage's ms, one
               train step's device time by where each operation ran);
               tools/k_equiv.py on the bench scene (K 5120 / 1024 / 512 /
               768); tools/staged_lossless.py on the 1M 512x512 staged
               workload (the draw's covers and the capacities sized from
               them, K 2048 / 1024 and the staged K 384 two-tier 12 each
               >= 60 dB against the lossless K with zero truncation, the
               gradient delta and the lossless gradient's transpose time,
               three timed train steps with peak memory), both kernels
               against their plain versions at the staged shape and the
               forward at the lossless K on half its tiles, with times
               and bounds
 15. at scale — the repo's at-scale runs through the port's tools
               (tools/flagship.py, ab_features.py, policy_multidof.py)
               at full width and short depth: the flagship (48
               mesh-raster targets at 512x512 with zero truncation, a
               500,000-slot pool from 20,000 points, K 2,048) trained 601
               steps of its 7,000-step schedule across the densify
               rounds at 480 and 600, each log line's loss, PSNR, alive
               count and overflow, one launch of each kernel a step, the
               step's ms, idle share and peak memory, held-out PSNR,
               both kernels against their plain versions at T 1,024 / P
               256 / K 2,048 on the trained state, timed and bounded;
               the seven feature arms 100 steps each at 512x512 (finite
               loss, held-out PSNR above the initial pool's, ms a step);
               the 2-DOF policy: 8 episodes of 36 frames (one forward
               launch a frame), 500 policy steps (the loss falls), 2
               closed-loop episodes at 50 DDIM steps, the forward
               against its plain version at its frame's shape (64x64,
               T 16, K 256, the meshes' depth limit), timed and bounded
 16. last runs — the repo's last runs that need no reference files,
               through the port's tools: profile_rollout on the
               Gaussian-only rollout frame (200k Gaussians, 4 x 640x480,
               no mesh; 5 iterations): the stage split, one camera /
               four sequential / one batched frame (4 and 1 forward
               launches), no truncation at M 64 / bbox 84 on any camera,
               K 2,048 / 1,024 / 512 and rollout_gate384's 384 >= 60 dB
               against K 8,192, the r4 config truncating, the forward
               against its plain version at K 512, at K 8,192 and
               batched, timed and bounded; staged_cover_stats on the
               rollout draw's cameras (the demand sums to the pairs, M
               64 / bbox 84 cover the maxima); ring_at_scale on 8 gloo
               ranks on the card at 524,288 and 1,048,576 Gaussians (ring
               against all_gather within 1e-6 / 1e-5, one launch of each
               kernel a step, each rank's peak bytes, the render law at
               world 2 / 4 / 8), both kernels against their plain
               versions on rank 0's merged blocks at 1M; the 8-rank
               multihost rehearsal on a (2, 4) mesh against one process;
               train_masknet 50 steps at 96 px (the loss falls)
The line before the last lists the kernels; the last line is the result.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# FP32 operations of the kernel per (pixel, splat) pair, an FMA counted
# as 2 and an SFU function (exp, log1p) as 1. Every evaluated pair: dx,
# dy (2), q (9), -q and exp (2), op * e (1), clamp (1), the alpha and q
# tests (2), the depth test with a limit (1).
FLOPS_EVAL = 17
FLOPS_EVAL_DLIM = 1
# each kept pair (alpha > 0): 1 - alpha, T update, weight gate, log1p, add
FLOPS_KEPT = 5
# each kept pair that passes the weight gate: alpha * T, 8 channel FMAs
FLOPS_WEIGHTED = 17
# the backward, per pair that its pixel enters with T >= t_min (from the
# first pair past that point a pixel adds 0: every later gate is false
# and the suffix is 0): the forward's alpha test (FLOPS_EVAL); each such
# kept pair log1p, the log-T step, exp, 1 - alpha, the gate (2) and the
# suffix term suffix / (1 - alpha) (2)
BWD_FLOPS_KEPT = 8
# each weighted pair: gamma (8 FMAs, 16), w and gamma * T and dL/dalpha
# (6), dq and the suffix update (4), the screen terms a dx + b dy and
# c dy + b dx (8), the 6 geometry products (10), the 8 dfeat products
# (8), and the 14 sums over the tile's pixels (14)
BWD_FLOPS_WEIGHTED = 66
BK = 128
N_TRAIN_STEPS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def psnr(a, b) -> float:
    import torch
    mse = float(torch.mean((a - b) ** 2))
    return float("inf") if mse == 0.0 else -10.0 * torch.log10(
        torch.tensor(mse)).item()


def cutoff_slack(geom, counts, nblk, dlim, tiles_x, cfg, n_tiles_per_image=0,
                 **_):
    """(T, P, 1): per pixel, the sum of -log1p(-alpha) over the pairs of
    the processed blocks whose alpha lies within the rounding of its own
    computation of the 1/255 cutoff: |raw - alpha_min| <= 8 eps32
    alpha_min (1 + s), s = |a| dx^2 / 2 + |c| dy^2 / 2 + |b dx dy| the
    terms q is summed from (the kernel contracts them into FMAs, the
    plain version rounds each; the 1 covers e^-q). Such a pair may be
    kept on one side only; the sum is the most those flips can move the
    pixel's final log T."""
    import torch
    from robosimgs_tpu_torch.render.gathered import (tile_alpha_parts,
                                                     tile_pixel_coords)
    T, _, K = geom.shape
    slots = torch.minimum(nblk.long() * BK, counts.long().clamp(0, K))
    t_img = torch.arange(T, device=geom.device) % (n_tiles_per_image or T)
    eps = torch.finfo(torch.float32).eps
    out = []
    for s in range(0, T, 64):
        e = min(s + 64, T)
        g = geom[s:e]
        px, py = tile_pixel_coords(t_img[s:e], tiles_x, cfg.tile_size)
        in_count = (torch.arange(K, device=geom.device)[None, :]
                    < slots[s:e, None])
        d = None if dlim is None else dlim[s:e, :, 0]
        _, _, raw, dx, dy = tile_alpha_parts(g, px, py, in_count, cfg, d)
        terms = (0.5 * (g[:, None, 2].abs() * dx * dx
                        + g[:, None, 4].abs() * dy * dy)
                 + (g[:, None, 3] * dx * dy).abs())
        near = in_count[:, None, :] & ((raw - cfg.alpha_min).abs()
                                       <= 8 * eps * cfg.alpha_min
                                       * (1.0 + terms))
        if d is not None:
            near = near & (g[:, None, 6] <= d[:, :, None])
        out.append(torch.where(near, -torch.log1p(-raw), 0.0).sum(dim=2))
    return torch.cat(out)[..., None]


def compare_fwd(got, want, tag, inputs):
    """nblk equal; out >= 60 dB with <= 1e-4 of channels off by > 1e-4;
    log-T within 1e-3 where above -20, save on pixels with a pair at the
    1/255 cutoff (`cutoff_slack`), which may be off by up to their slack
    and are counted; log_t_groups (its
    groups of the processed blocks, where above -20) with <= 1e-4 of its
    entries off by > 1e-3 (such a pair moves the group ends after it by
    log1p(-1/255) = -3.9e-3, also on pixels whose final log-T may be
    below -20). inputs: (geom, counts, dlim, the wrappers' keywords).
    Returns (max |out err|, flips)."""
    import torch
    from robosimgs_tpu_torch.render.kernels import LT_GROUP
    (out, tfin, nblk, ltg), (rout, rtfin, rnblk, rltg) = got, want
    n_diff = int((nblk != rnblk).sum())
    if n_diff:
        raise AssertionError(f"{tag}: nblk differs on {n_diff} tiles")
    err = (out - rout).abs()
    off = err > 1e-4
    frac = float(off.float().mean())
    flips = int(off.any(dim=1).sum())      # pixels with any channel off
    db = psnr(out, rout)
    lt_err = ltg_err = ltg_frac = 0.0
    n_cut = n_over = 0
    live_t = rtfin > -20
    if bool(live_t.any()):
        lt_dev = (tfin - rtfin).abs()
        lt_err = float(lt_dev[live_t].max())
        past = live_t & (lt_dev > 1e-3)
        n_cut = int(past.sum())
        if n_cut:
            geom, counts, dlim, kw = inputs
            slack = cutoff_slack(geom, counts, rnblk, dlim, **kw)
            n_over = int((past & (lt_dev > 1e-3 + slack)).sum())
    done = (torch.arange(ltg.shape[1], device=ltg.device)[None, :]
            < rnblk[:, None].long() * (BK // LT_GROUP))[:, :, None]
    live = done & (rltg > -20)
    if bool(live.any()):
        ltg_dev = (ltg - rltg).abs()[live]
        ltg_err = float(ltg_dev.max())
        ltg_frac = float((ltg_dev > 1e-3).float().mean())
    max_err = float(err.max())
    log(f"  {tag}: max|out err| {max_err:.3e}  psnr {db:.1f} dB  "
        f"off>1e-4 {frac:.2e} ({flips} pixels)  max|logT err| {lt_err:.3e} "
        f"({n_cut} pixels past 1e-3, {n_over} of them past their slack "
        f"for pairs at the 1/255 cutoff)  log_t_groups max|err| "
        f"{ltg_err:.3e}, "
        f"off>1e-3 {ltg_frac:.2e}  nblk equal on {nblk.numel()} tiles")
    if db < 60.0 or frac > 1e-4 or n_over or ltg_frac > 1e-4:
        raise AssertionError(f"{tag}: kernel disagrees with the plain version")
    return max_err, flips


def compare_bwd(got, want, tag):
    """Per row: at most 1e-4 of the slots off by more than 1e-4 + 1e-3
    |plain|. Returns the max |err| over both outputs."""
    import torch
    max_err, worst = 0.0, 0.0
    for name, a, b in zip(("dgeom", "dfeat"), got, want):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{tag}: non-finite {name}")
        err = (a - b).abs()
        off = (err > 1e-4 + 1e-3 * b.abs()).float().mean(dim=(0, 2))
        worst = max(worst, float(off.max()))
        max_err = max(max_err, float(err.max()))
        log(f"  {tag} {name}: max|err| per row "
            + " ".join(f"{float(e):.2e}" for e in err.amax(dim=(0, 2)))
            + f" (max|plain| {float(b.abs().max()):.3g}); slots off per row "
            + " ".join(f"{float(o):.1e}" for o in off))
    if worst > 1e-4:
        raise AssertionError(f"{tag}: backward kernel disagrees with the "
                             f"plain version ({worst:.2e} of a row's slots)")
    return max_err


def quadrant_check(geom, feat, counts, dlim, full, kw, tag) -> dict:
    """The forward on tiles over 16x16 (its cluster instance; `full` its
    outputs) against the forward on each tile's quadrants
    (tools/quadrants.py): out on every pixel, log_t_final where a
    quadrant's nblk is its tile's and log_t_groups on the batches both
    processed, each 0.0 apart, and each tile's nblk its quadrants'
    largest; then against the cluster instance walking every slot
    (skip "none"), every output 0.0 apart. Returns quadrant_diffs'
    numbers."""
    from robosimgs_tpu_torch.render.kernels import composite_fwd
    from robosimgs_tpu_torch.tools.quadrants import (forward_diffs,
                                                     quadrant_blocks,
                                                     quadrant_diffs)
    *half_in, kw_half = quadrant_blocks(geom, feat, counts, dlim, **kw)
    half = composite_fwd(*half_in, **kw_half, skip="none")
    d = quadrant_diffs(full, half, **kw)
    every = forward_diffs(full, composite_fwd(geom, feat, counts, dlim, **kw,
                                              skip="none"))
    log(f"  {tag}: against {kw_half['cfg'].tile_size}x"
        f"{kw_half['cfg'].tile_size} quadrants: max|out diff| {d['out']}, "
        f"log_t_final {d['log_t_final']} ({d['tiles_equal']} of "
        f"{half[2].numel()} quadrants at their tile's nblk), log_t_groups "
        f"{d['log_t_groups']}; tiles whose nblk is not their quadrants' "
        f"largest: {d['nblk_over']}; against every slot walked: {every}")
    if d["nblk_over"] or d["out"] or d["log_t_final"] or d["log_t_groups"]:
        raise AssertionError(f"{tag}: the forward differs from its quadrants")
    if any(every.values()):
        raise AssertionError(f"{tag}: the skip changes the forward's bits")
    return d


def gate_flips(geom, counts, nblk, dlim, tiles_x, cfg, n_tiles_per_image=0):
    """Pixels whose weight gate T (1 - alpha) >= 1e-4 a linear T (a
    running product, as the forward kernel keeps it) and a log T (a
    running sum of log1p(-alpha), as the backward rebuilds it) decide
    differently on some kept splat of the processed blocks — computed
    in torch, so it estimates, and does not read, the kernels' gates."""
    import torch
    from robosimgs_tpu_torch.render.gathered import (tile_alpha,
                                                     tile_pixel_coords)
    T, _, K = geom.shape
    slots = torch.minimum(nblk.long() * BK, counts.long().clamp(0, K))
    t_img = torch.arange(T, device=geom.device) % (n_tiles_per_image or T)
    flips = 0
    for s in range(0, T, 64):
        e = min(s + 64, T)
        px, py = tile_pixel_coords(t_img[s:e], tiles_x, cfg.tile_size)
        in_count = (torch.arange(K, device=geom.device)[None, :]
                    < slots[s:e, None])
        alpha = tile_alpha(geom[s:e], px, py, in_count, cfg,
                           None if dlim is None else dlim[s:e, :, 0])
        om = 1.0 - alpha
        t_lin = torch.cumprod(om, dim=2) / om
        lg = torch.log1p(-alpha)
        t_log = torch.exp(torch.cumsum(lg, dim=2) - lg)
        kept = alpha > 0
        lin = t_lin * om >= cfg.transmittance_min
        lgt = t_log * om >= cfg.transmittance_min
        flips += int((kept & (lin != lgt)).any(dim=2).sum())
    return flips


def pair_work(geom, counts, nblk, dlim, tiles_x, cfg, n_tiles_per_image=0):
    """(pixel, splat) pair counts of the kernels' run on these inputs, over
    the slots of the processed blocks: (evaluated, kept, weighted, live,
    live_kept). kept: alpha > 0; weighted: kept and through the weight
    gate; live: the pixel enters the splat with T >= transmittance_min
    (log T from a cumsum over the slots), the only pairs the backward
    needs; live_kept: live and kept. Any tile size up to 32x32 (P pixels
    a tile); tile t at the pixels of tile t % n_tiles_per_image."""
    import torch
    from robosimgs_tpu_torch.render.gathered import (tile_alpha,
                                                     tile_pixel_coords)
    T, _, K = geom.shape
    P = cfg.tile_size ** 2
    lt_min = math.log(cfg.transmittance_min)
    slots = torch.minimum(nblk.long() * BK, counts.long().clamp(0, K))
    t_img = torch.arange(T, device=geom.device) % (n_tiles_per_image or T)
    kept = weighted = live = live_kept = 0
    for s in range(0, T, 64):
        e = min(s + 64, T)
        px, py = tile_pixel_coords(t_img[s:e], tiles_x, cfg.tile_size)
        in_count = (torch.arange(K, device=geom.device)[None, :]
                    < slots[s:e, None])
        alpha = tile_alpha(geom[s:e], px, py, in_count, cfg,
                           None if dlim is None else dlim[s:e, :, 0])
        lg = torch.log1p(-alpha)
        lt_in = torch.cumsum(lg, dim=2) - lg       # log T entering the splat
        keep = alpha > 0
        alive = (lt_in >= lt_min) & in_count[:, None, :]
        kept += int(keep.sum())
        weighted += int((keep & (torch.exp(lt_in) * (1.0 - alpha)
                                 >= cfg.transmittance_min)).sum())
        live += int(alive.sum())
        live_kept += int((alive & keep).sum())
    return int(slots.sum()) * P, kept, weighted, live, live_kept


def skipped_pairs(geom, feat, counts, tiles_x, cfg, n_tiles_per_image=0):
    """The (pixel, splat) pairs of the processed blocks that the forward
    kernel skips by its footprint test, as it counts them itself (one
    more launch, with a pair counter, at the grain the wrapper picks):
    {"skipped", "processed" (fwd_bound's evaluated count, which the
    kernel's own must equal), "grain", "mirror" (the pairs that
    render/kernels.py::footprint_misses, the test in torch, predicts the
    kernel skips; logged beside the kernel's count, nothing rests on it)}."""
    import torch
    from robosimgs_tpu_torch.render.kernels import (composite_fwd,
                                                    footprint_misses,
                                                    fwd_skip_grain,
                                                    fwd_skip_groups)
    T, _, K = geom.shape
    grain = fwd_skip_grain(T, cfg.tile_size, torch.cuda.get_device_properties(
        geom.device).multi_processor_count)
    pairs = torch.zeros(2, dtype=torch.int64, device=geom.device)
    nblk = composite_fwd(geom, feat, counts, None, tiles_x=tiles_x, cfg=cfg,
                         n_tiles_per_image=n_tiles_per_image, has_dlim=False,
                         pairs=pairs)[2]
    walked, processed = (int(v) for v in pairs.cpu())
    slots = torch.minimum(nblk.long() * BK, counts.long().clamp(0, K))
    if processed != int(slots.sum()) * cfg.tile_size ** 2:
        raise AssertionError(f"the forward counted {processed} processed "
                             f"pairs, its blocks hold "
                             f"{int(slots.sum()) * cfg.tile_size ** 2}")
    size = torch.tensor([b - a for a, b in fwd_skip_groups(cfg.tile_size,
                                                             grain)],
                        device=geom.device)
    t_img = torch.arange(T, device=geom.device) % (n_tiles_per_image or T)
    mirror = 0
    for s in range(0, T, 16):
        e = min(s + 16, T)
        m = footprint_misses(geom[s:e], tiles_x=tiles_x, cfg=cfg,
                             grain=grain, t_idx=t_img[s:e])
        done = torch.arange(K, device=geom.device)[None, :] < slots[s:e, None]
        mirror += int(((m & done[:, None, :]).sum(dim=2) * size).sum())
    return dict(skipped=processed - walked, processed=processed, grain=grain,
                mirror=mirror)


def skip_line(sk) -> str:
    """skipped_pairs' numbers as a log line's clause."""
    return (f"the footprint test ({sk['grain']}) skips {sk['skipped']} of "
            f"the {sk['processed']} evaluated pairs "
            f"({sk['skipped'] / sk['processed']:.4f}; the kernel's count; "
            f"its torch mirror predicts {sk['mirror']})")


def fwd_bound(geom, counts, nblk, dlim, tiles_x, cfg, n_tiles_per_image=0):
    """The forward kernel's bound on these inputs, from the pairs of its
    processed blocks: (bound_ms, "operations" or "bytes", a line that
    shows the count, pair_work's counts). Bytes: counts, geom rows 0..5
    (and the depth row 6 with a limit) and feat rows 0..7 of the
    evaluated slots, the limit, out (8 rows), log-T, nblk and the
    processed groups of log_t_groups."""
    from robosimgs_tpu_torch.render.kernels import LT_GROUP
    work = pair_work(geom, counts, nblk, dlim, tiles_x, cfg,
                     n_tiles_per_image)
    pairs, kept, weighted = work[:3]
    T, P = geom.shape[0], cfg.tile_size ** 2
    n_slots = pairs // P
    has_dlim = dlim is not None
    n_ltg = int(nblk.sum()) * (BK // LT_GROUP) * P
    nbytes = 4 * (T + (15 if has_dlim else 14) * n_slots
                  + (T * P if has_dlim else 0) + 8 * T * P + T * P + T + n_ltg)
    per_eval = FLOPS_EVAL + (FLOPS_EVAL_DLIM if has_dlim else 0)
    flops = per_eval * pairs + FLOPS_KEPT * kept + FLOPS_WEIGHTED * weighted
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    detail = (f"{bound_by}: {flops} flop = {pairs} evaluated x {per_eval} + "
              f"{kept} kept x {FLOPS_KEPT} + {weighted} weighted x "
              f"{FLOPS_WEIGHTED}, {ops_ms:.6f} ms; {nbytes} B, {bytes_ms:.6f} "
              f"ms; blocks {int(nblk.sum())}")
    return max(ops_ms, bytes_ms), bound_by, detail, work


def bwd_bound(geom, counts, nblk, dlim, tiles_x, cfg, work=None):
    """The backward kernel's bound on these inputs: (bound_ms, "operations"
    or "bytes", a line that shows the count). Operations: the pairs their
    pixels enter unsaturated (the forward must evaluate every pair of the
    processed blocks for its log-T residuals; the backward needs no
    others). Bytes: counts, nblk, geom rows 0..5 (and the depth row with
    a limit) and feat rows 0..7 of the evaluated slots, the limit, gout
    (8 rows), log-T, the processed groups of log_t_groups, and dgeom +
    dfeat (16 rows) of every slot. work: pair_work's counts, if at hand."""
    from robosimgs_tpu_torch.render.kernels import LT_GROUP
    pairs, _, weighted, live, live_kept = work or pair_work(
        geom, counts, nblk, dlim, tiles_x, cfg)
    T, _, K = geom.shape
    P = cfg.tile_size ** 2
    n_slots = pairs // P
    has_dlim = dlim is not None
    n_ltg = int(nblk.sum()) * (BK // LT_GROUP) * P
    per_eval = FLOPS_EVAL + (FLOPS_EVAL_DLIM if has_dlim else 0)
    flops = (per_eval * live + BWD_FLOPS_KEPT * live_kept
             + BWD_FLOPS_WEIGHTED * weighted)
    nbytes = 4 * (2 * T + (15 if has_dlim else 14) * n_slots
                  + (T * P if has_dlim else 0) + 8 * T * P + T * P + n_ltg
                  + 16 * T * K)
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    detail = (f"{bound_by}: {flops} flop = {live} unsaturated pairs "
              f"({live / max(pairs, 1):.4f} of the evaluated) x {per_eval} + "
              f"{live_kept} of them kept x {BWD_FLOPS_KEPT} + {weighted} "
              f"weighted x {BWD_FLOPS_WEIGHTED}, {ops_ms:.6f} ms; {nbytes} B, "
              f"{bytes_ms:.6f} ms")
    return max(ops_ms, bytes_ms), bound_by, detail


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1

    import numpy as np

    from robosimgs_tpu_torch import Camera, Gaussians
    from robosimgs_tpu_torch.cli import render as cli_render
    from robosimgs_tpu_torch.render import _build, rasterize
    from robosimgs_tpu_torch.render.binning import bin_and_gather_packed
    from robosimgs_tpu_torch.render.config import RenderConfig
    from robosimgs_tpu_torch.cli import train as cli_train
    from robosimgs_tpu_torch.render.kernels import (composite_bwd,
                                                    composite_bwd_plain,
                                                    composite_fwd,
                                                    composite_fwd_plain)
    from robosimgs_tpu_torch.render.project import project
    from robosimgs_tpu_torch.render.tiled import composite_tiled
    from robosimgs_tpu_torch.render.tiles import num_tiles
    from robosimgs_tpu_torch.train.data import Frame
    from robosimgs_tpu_torch.train.io_ply import load_ply, save_ply
    from robosimgs_tpu_torch.train.losses import photometric_loss
    from robosimgs_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                   make_train_step)
    from robosimgs_tpu_torch.tools.workloads import (BENCH_GAUSSIANS,
                                                     bench_scene, orbit_views,
                                                     saturated_scene, time_ms)
    from robosimgs_tpu_torch.utils.imresize import read_png_rgb
    from robosimgs_tpu_torch.utils.profiling import device_rows

    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"[1 device] {kind} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi)   # the card's name and power limit, as nvidia-smi gives them

    # 2. build: one nvcc per source, started together
    t_build = time.perf_counter()
    for name, built in _build.build_all(["composite_fwd",
                                         "composite_bwd"]).items():
        log(f"[2 build] {name}: {built.seconds:.1f} s "
            f"{'(already built)' if not built.ptxas else built.ptxas}")
    log(f"  both built in {time.perf_counter() - t_build:.1f} s")

    # 3. kernel against plain on the card, bench workload
    g, cam, cfg = bench_scene(dev)
    res = cam.width
    cam2 = Camera.look_at([-3.0, 2.5, 1.0], [0, 0, 0], [0, 0, 1], 60.0,
                          res, res, device=dev)
    tiles_x, _ = num_tiles(res, res, cfg.tile_size)
    P = cfg.tile_size ** 2
    with torch.no_grad():
        geom, feat, counts, stats = bin_and_gather_packed(
            project(g, cam, cfg), res, res, cfg)
        geom2, feat2, counts2, _ = bin_and_gather_packed(
            project(g, cam2, cfg), res, res, cfg)
    trunc = int(stats.truncated_gaussians)
    log(f"[3 kernel] T={geom.shape[0]} K={geom.shape[2]} "
        f"tile_pairs={int(stats.total_pairs)} max_tile_count="
        f"{int(stats.max_tile_count)} truncated={trunc} "
        f"overflowed_tiles={int(stats.overflowed_tiles)}")
    kw = dict(tiles_x=tiles_x, cfg=cfg, has_dlim=False)
    fwd = composite_fwd(geom, feat, counts, None, **kw)
    torch.cuda.synchronize()
    err_a, flips_a = compare_fwd(
        fwd, composite_fwd_plain(geom, feat, counts, None, **kw), "no dlim",
        (geom, counts, None, kw))
    geom_b, feat_b = torch.cat([geom, geom2]), torch.cat([feat, feat2])
    counts_b = torch.cat([counts, counts2])
    T2 = geom_b.shape[0]
    dlim = (torch.rand((T2, P, 1), generator=torch.Generator().manual_seed(1))
            * 4.0 + 2.0).to(dev)
    kw_b = dict(tiles_x=tiles_x, cfg=cfg, n_tiles_per_image=T2 // 2,
                has_dlim=True)
    got_b = composite_fwd(geom_b, feat_b, counts_b, dlim, **kw_b)
    torch.cuda.synchronize()
    err_b, flips_b = compare_fwd(
        got_b, composite_fwd_plain(geom_b, feat_b, counts_b, dlim, **kw_b),
        "dlim + 2 images", (geom_b, counts_b, dlim, kw_b))
    log(f"  gate flips: {flips_a} + {flips_b} pixels")

    # 3b. the backward kernel against its plain version, on the forward
    # kernel's residuals; cotangent N(0, 1) on all 8 rows
    def gout_like(out, seed):
        return torch.randn(out.shape, generator=torch.Generator()
                           .manual_seed(seed)).to(dev)

    gout = gout_like(fwd[0], 3)
    bwd = composite_bwd(geom, feat, counts, None, gout, *fwd[1:], **kw)
    torch.cuda.synchronize()
    err_bwd = compare_bwd(bwd, composite_bwd_plain(
        geom, feat, counts, None, gout, *fwd[1:], **kw), "bwd no dlim")
    gout_b = gout_like(got_b[0], 4)
    got_bb = composite_bwd(geom_b, feat_b, counts_b, dlim, gout_b, *got_b[1:],
                           **kw_b)
    torch.cuda.synchronize()
    err_bwd = max(err_bwd, compare_bwd(got_bb, composite_bwd_plain(
        geom_b, feat_b, counts_b, dlim, gout_b, *got_b[1:], **kw_b),
        "bwd dlim + 2 images"))
    cfg_abs = RenderConfig(**{**cfg.__dict__, "absgrad": True})
    with torch.no_grad():
        geom_a, feat_a, counts_a, _ = bin_and_gather_packed(
            project(g, cam, cfg_abs,
                    abs_probe=torch.zeros((g.capacity, 2), device=dev)),
            res, res, cfg_abs)
    kw_a = dict(tiles_x=tiles_x, cfg=cfg_abs, has_dlim=False)
    fwd_a = composite_fwd(geom_a, feat_a, counts_a, None, **kw_a)
    gout_a = gout_like(fwd_a[0], 5)
    got_ba = composite_bwd(geom_a, feat_a, counts_a, None, gout_a, *fwd_a[1:],
                           **kw_a)
    torch.cuda.synchronize()
    err_bwd = max(err_bwd, compare_bwd(got_ba, composite_bwd_plain(
        geom_a, feat_a, counts_a, None, gout_a, *fwd_a[1:], **kw_a),
        "bwd absgrad"))
    if float(got_ba[0][:, 7].max()) <= 0.0:
        raise AssertionError("absgrad rows are empty")
    # 3c. where the kernels skip work: a saturated stack, a sparse view
    err_skip = 0.0
    for tag, (g_k, cam_k, cfg_k) in (
            ("saturated stack", saturated_scene(dev)),
            ("sparse view", (Gaussians.random(
                torch.Generator().manual_seed(7), 60, sh_degree=3,
                extent=1.5, device=dev), cam, cfg))):
        with torch.no_grad():
            geom_k, feat_k, counts_k, stats_k = bin_and_gather_packed(
                project(g_k, cam_k, cfg_k), cam_k.width, cam_k.height, cfg_k)
        if int(stats_k.truncated_gaussians) != 0:
            raise AssertionError(f"{tag}: truncates")
        kw_k = dict(tiles_x=num_tiles(cam_k.width, cam_k.height,
                                      cfg_k.tile_size)[0],
                    cfg=cfg_k, has_dlim=False)
        fwd_k = composite_fwd(geom_k, feat_k, counts_k, None, **kw_k)
        torch.cuda.synchronize()
        log(f"  {tag}: T={geom_k.shape[0]} K={geom_k.shape[2]} counts max "
            f"{int(counts_k.max())} nonzero {int((counts_k > 0).sum())}, "
            f"nblk max {int(fwd_k[2].max())}")
        err_skip = max(err_skip, compare_fwd(fwd_k, composite_fwd_plain(
            geom_k, feat_k, counts_k, None, **kw_k), tag,
            (geom_k, counts_k, None, kw_k))[0])
        gout_k = gout_like(fwd_k[0], 6)
        bwd_k = composite_bwd(geom_k, feat_k, counts_k, None, gout_k,
                              *fwd_k[1:], **kw_k)
        torch.cuda.synchronize()
        err_bwd = max(err_bwd, compare_bwd(bwd_k, composite_bwd_plain(
            geom_k, feat_k, counts_k, None, gout_k, *fwd_k[1:], **kw_k),
            f"bwd {tag}"))
        if float(bwd_k[0][:, :6].abs().max()) <= 0.0:
            raise AssertionError(f"{tag}: zero geometry gradients")
    # 3d. the forward on 32x32 tiles (the JAX package's tile size for its
    # 3M-Gaussian config): the kernel's cluster instance
    cfg_32 = RenderConfig(tile_size=32, tile_capacity=1024)
    with torch.no_grad():
        geom_32, feat_32, counts_32, _ = bin_and_gather_packed(
            project(g, cam, cfg_32), res, res, cfg_32)
    kw_32 = dict(tiles_x=num_tiles(res, res, 32)[0], cfg=cfg_32,
                 has_dlim=False)
    fwd_32 = composite_fwd(geom_32, feat_32, counts_32, None, **kw_32)
    torch.cuda.synchronize()
    log(f"  32x32 tiles: T={geom_32.shape[0]} K={geom_32.shape[2]} counts "
        f"max {int(counts_32.max())}, nblk max {int(fwd_32[2].max())}")
    err_skip = max(err_skip, compare_fwd(fwd_32, composite_fwd_plain(
        geom_32, feat_32, counts_32, None, **kw_32), "32x32 tiles",
        (geom_32, counts_32, None, kw_32))[0])
    # 3e. the backward on 32x32 tiles (its split kernel): on 3d's
    # residuals (K=1024), at the bench workload's K=384 (T=64; K is the
    # 16x16 capacity, so deep tiles truncate, which the kernel does not
    # mind) with and without a depth limit, and on ragged 12x12 tiles
    gout_32 = gout_like(fwd_32[0], 20)
    err_32 = compare_bwd(composite_bwd(
        geom_32, feat_32, counts_32, None, gout_32, *fwd_32[1:], **kw_32),
        composite_bwd_plain(geom_32, feat_32, counts_32, None, gout_32,
                            *fwd_32[1:], **kw_32), "bwd 32x32 tiles K=1024")
    cfg_t32 = RenderConfig(**{**cfg.__dict__, "tile_size": 32})
    with torch.no_grad():
        geom_t32, feat_t32, counts_t32, _ = bin_and_gather_packed(
            project(g, cam, cfg_t32), res, res, cfg_t32)
    tx_32 = num_tiles(res, res, 32)[0]
    dlim_t32 = (torch.rand((geom_t32.shape[0], 1024, 1), generator=torch
                           .Generator().manual_seed(21)) * 4.0 + 2.0).to(dev)
    for tag, d in (("no dlim", None), ("dlim", dlim_t32)):
        kw_t = dict(tiles_x=tx_32, cfg=cfg_t32, has_dlim=d is not None)
        fwd_t = composite_fwd(geom_t32, feat_t32, counts_t32, d, **kw_t)
        gout_t = gout_like(fwd_t[0], 22)
        got_t = composite_bwd(geom_t32, feat_t32, counts_t32, d, gout_t,
                              *fwd_t[1:], **kw_t)
        torch.cuda.synchronize()
        err_32 = max(err_32, compare_bwd(got_t, composite_bwd_plain(
            geom_t32, feat_t32, counts_t32, d, gout_t, *fwd_t[1:], **kw_t),
            f"bwd 32x32 tiles K=384 {tag}"))
    log(f"  32x32 tiles at the bench K: T={geom_t32.shape[0]} "
        f"K={geom_t32.shape[2]}, counts max {int(counts_t32.max())}, nblk "
        f"max {int(fwd_t[2].max())} with the limit")
    cfg_12 = RenderConfig(tile_size=12, tile_capacity=1024)
    with torch.no_grad():
        geom_12, feat_12, counts_12, _ = bin_and_gather_packed(
            project(g, cam, cfg_12), res, res, cfg_12)
    kw_12 = dict(tiles_x=num_tiles(res, res, 12)[0], cfg=cfg_12,
                 has_dlim=False)
    fwd_12 = composite_fwd(geom_12, feat_12, counts_12, None, **kw_12)
    gout_12 = gout_like(fwd_12[0], 23)
    err_32 = max(err_32, compare_bwd(
        composite_bwd(geom_12, feat_12, counts_12, None, gout_12,
                      *fwd_12[1:], **kw_12),
        composite_bwd_plain(geom_12, feat_12, counts_12, None, gout_12,
                            *fwd_12[1:], **kw_12), "bwd ragged 12x12 tiles"))
    with torch.no_grad():
        gflip_a = gate_flips(geom, counts, fwd[2], None, tiles_x, cfg)
        gflip_b = gate_flips(geom_b, counts_b, got_b[2], dlim, tiles_x, cfg,
                             T2 // 2)
    log(f"  forward/backward gate disagreements (linear vs log T, torch "
        f"estimate): {gflip_a} of {geom.shape[0] * P} pixels, {gflip_b} of "
        f"{T2 * P} with dlim")

    # 4. main path: rasterize through the kernel
    if trunc != 0:
        raise AssertionError(f"bench config truncates {trunc} gaussians")
    composite_fwd.launches = 0
    with torch.no_grad():
        out = rasterize(g, cam, cfg, impl="tiled")
    torch.cuda.synchronize()
    launches_main = composite_fwd.launches
    if launches_main < 1:
        raise AssertionError("rasterize did not launch the kernel")
    for k, v in out.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite {k}")
    if tuple(out["rgb"].shape) != (res, res, 3):
        raise AssertionError(f"rgb shape {tuple(out['rgb'].shape)}")
    cfg_lossless = RenderConfig(tile_capacity=5120, tile_chunk=512,
                                max_tiles_per_gaussian=12)
    with torch.no_grad():
        full = rasterize(g, cam, cfg_lossless, impl="tiled")
    eq_db = psnr(out["rgb"], full["rgb"])
    log(f"[4 main] rasterize {res}x{res}: launches {launches_main}, "
        f"alpha mean {float(out['alpha'].mean()):.4f}, "
        f"K={cfg.tile_capacity} vs lossless K=5120: {eq_db:.1f} dB")
    if eq_db < 60.0:
        raise AssertionError(f"K={cfg.tile_capacity} render at {eq_db} dB")
    small = Gaussians.random(torch.Generator().manual_seed(2), 2000,
                             sh_degree=3, extent=1.5, device=dev)
    cam_s = Camera.look_at([4.0, 0.5, 1.2], [0, 0, 0], [0, 0, 1], 60.0,
                           64, 48, device=dev)
    cfg_s = RenderConfig(tile_capacity=1024)
    with torch.no_grad():
        out_s = rasterize(small, cam_s, cfg_s)
        ref_s = rasterize(small.to("cpu"), cam_s.to("cpu"), cfg_s,
                          impl="reference")
    ref_err = max(float((out_s[k].cpu() - ref_s[k]).abs().max())
                  for k in ("rgb", "alpha", "depth"))
    log(f"  small scene vs CPU reference: max abs err {ref_err:.3e}")
    if ref_err > 2e-3:
        raise AssertionError("tiled render disagrees with the reference")

    # 4b. the training main path: Trainer steps at the bench width
    target = np.zeros((res, res, 3), np.float32)
    cfg_train = TrainConfig(render=cfg, impl="tiled", sh_warmup_every=1,
                            densify_from=10**9, opacity_reset_interval=10**9,
                            dynamic_pool=False, log_every=1)
    trainer = Trainer(cfg_train, g, [Frame(camera=cam, image=target)])
    composite_fwd.launches = composite_bwd.launches = 0
    trainer.run(iterations=3, progress=False)
    torch.cuda.synchronize()
    launches_train = (composite_fwd.launches, composite_bwd.launches)
    losses = [h["loss"] for h in trainer.history]
    log(f"[4 main] Trainer 3 steps at {res}x{res}: launches fwd "
        f"{launches_train[0]} bwd {launches_train[1]}, loss "
        + " ".join(f"{x:.6f}" for x in losses)
        + f", overflow {[h['overflow'] for h in trainer.history]}")
    if launches_train != (3, 3):
        raise AssertionError(f"train steps launched {launches_train}, want "
                             f"one forward and one backward per step")
    # the step's overflow metric also counts tiles past K=384, which the
    # bench accepts under its 60 dB gate; truncated Gaussians it does not
    with torch.no_grad():
        *_, st_train = bin_and_gather_packed(
            project(trainer.state.gaussians, cam, cfg), res, res, cfg)
    trunc_train = int(st_train.truncated_gaussians)
    log(f"  after the steps: truncated {trunc_train}, overflowed tiles "
        f"{int(st_train.overflowed_tiles)}")
    if trunc_train != 0:
        raise AssertionError("the train step truncates")
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite loss")
    # per-Gaussian gradients on a small scene: card against CPU path;
    # anisotropic splats (an isotropic one's rotation has no gradient)
    aniso = small.replace(log_scales=small.log_scales + 0.5 * torch.randn(
        small.log_scales.shape, generator=torch.Generator().manual_seed(6)
    ).to(dev))
    grads = {}
    for d in ("cpu", "cuda"):
        gg = aniso.to(d)
        params = {k: getattr(gg, k).clone().requires_grad_()
                  for k in ("means", "quats", "log_scales", "logit_opacities",
                            "sh_dc", "sh_rest")}
        out_g = composite_tiled(project(gg.replace(**params), cam_s.to(d),
                                        cfg_s), 64, 48, cfg_s)
        photometric_loss(out_g["rgb"], torch.full((48, 64, 3), 0.3,
                                                  device=d)).backward()
        grads[d] = {k: v.grad.cpu() for k, v in params.items()}
    for k, want_g in grads["cpu"].items():
        e = float((grads["cuda"][k] - want_g).abs().max())
        scale = float(want_g.abs().max())
        log(f"  grad {k}: max|card - cpu| {e:.3e} of max {scale:.3e}")
        if e > 1e-3 * scale:
            raise AssertionError(f"{k} gradients differ on the card")

    # 5. entry point: the render CLI
    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "scene.ply")
        save_ply(ply, g)
        views = os.path.join(tmp, "views")
        composite_fwd.launches = 0
        cli_render.main([ply, "--output", views, "--orbit", "2",
                         "--width", "640", "--height", "480"])
        launches_cli = composite_fwd.launches
        for i in range(2):
            img = read_png_rgb(os.path.join(views, f"orbit_{i:04d}.png"))
            if img.shape != (480, 640, 3) or int(img.std() * 1000) == 0:
                raise AssertionError(f"orbit {i}: blank or misshapen PNG")
        g_cli = load_ply(ply, device=dev)
    log(f"[5 entry] cli.render 2 x 640x480 orbit PNGs, launches {launches_cli}")
    if launches_cli < 2:
        raise AssertionError("the CLI did not render through the kernel")
    # the kernel against its plain version at the CLI's shapes: the same
    # scene, orbit cameras and default RenderConfig the CLI rendered with
    err_cli = 0.0
    for i, (cam_o, cfg_cli) in enumerate(orbit_views(g_cli, dev)):
        tx, ty = num_tiles(640, 480, cfg_cli.tile_size)
        with torch.no_grad():
            geom_o, feat_o, counts_o, stats_o = bin_and_gather_packed(
                project(g_cli, cam_o, cfg_cli), 640, 480, cfg_cli)
        kw_o = dict(tiles_x=tx, cfg=cfg_cli, has_dlim=False)
        got_o = composite_fwd(geom_o, feat_o, counts_o, None, **kw_o)
        torch.cuda.synchronize()
        log(f"  orbit {i}: T={geom_o.shape[0]} ({tx}x{ty} tiles) "
            f"K={geom_o.shape[2]} max_tile_count={int(stats_o.max_tile_count)}"
            f" truncated={int(stats_o.truncated_gaussians)} blocks per tile "
            f"max {int(got_o[2].max())} mean {float(got_o[2].float().mean()):.2f}")
        e_o, _ = compare_fwd(got_o, composite_fwd_plain(
            geom_o, feat_o, counts_o, None, **kw_o), f"orbit {i} 640x480",
            (geom_o, counts_o, None, kw_o))
        err_cli = max(err_cli, e_o)
        gout_o = gout_like(got_o[0], 10 + i)
        bwd_o = composite_bwd(geom_o, feat_o, counts_o, None, gout_o,
                              *got_o[1:], **kw_o)
        torch.cuda.synchronize()
        err_bwd = max(err_bwd, compare_bwd(bwd_o, composite_bwd_plain(
            geom_o, feat_o, counts_o, None, gout_o, *got_o[1:], **kw_o),
            f"bwd orbit {i} 640x480"))
        with torch.no_grad():
            flips_o = gate_flips(geom_o, counts_o, got_o[2], None, tx, cfg_cli)
        log(f"  orbit {i}: forward/backward gate disagreements {flips_o}")

    # the train CLI: one densify round and a pool resize at step 500
    with tempfile.TemporaryDirectory() as tmp:
        composite_fwd.launches = composite_bwd.launches = 0
        t_cli = time.perf_counter()
        cli_train.main(["--synthetic", "20000", "--iterations", "600",
                        "--capacity", "65536", "--output", tmp])
        cli_s = time.perf_counter() - t_cli
        launches_cli_train = (composite_fwd.launches, composite_bwd.launches)
        with open(os.path.join(tmp, "train_summary.json")) as fh:
            summary = json.load(fh)
        hist = summary["history"]
        log(f"[5 entry] cli.train --synthetic 20000 --iterations 600 "
            f"--capacity 65536: "
            f"{cli_s:.1f} s, launches fwd {launches_cli_train[0]} bwd "
            f"{launches_cli_train[1]}, psnr by log step "
            + " ".join(f"{h['step']}:{h['psnr']:.2f}" for h in hist)
            + f", alive {hist[0]['n_alive']:.0f} -> {summary['n_alive']}, "
            f"eval psnr {summary['psnr']:.2f} ssim {summary['ssim']:.4f}")
        if launches_cli_train[1] != 600:
            raise AssertionError("the train CLI did not run its 600 steps "
                                 "through the backward kernel")
        if not hist[-1]["psnr"] > hist[0]["psnr"]:
            raise AssertionError("cli.train did not raise PSNR")
        ply_t = os.path.join(tmp, "scene.ply")
        view_t = os.path.join(tmp, "trained.png")
        composite_fwd.launches = 0
        cli_render.main([ply_t, "--output", view_t, "--eye", "4", "0", "1",
                         "--width", "256", "--height", "256"])
        img = read_png_rgb(view_t)
        if img.shape != (256, 256, 3) or int(img.std() * 1000) == 0 \
                or composite_fwd.launches != 1:
            raise AssertionError("the trained scene did not render")
        log(f"  cli.render of the trained scene.ply: 256x256 PNG, std "
            f"{img.std():.1f}")

    # 6. times at the bench shape
    with torch.no_grad():
        kernel_ms = time_ms(lambda: composite_fwd(geom, feat, counts, None,
                                                  **kw), reps=200)
        plain_ms = time_ms(lambda: composite_fwd_plain(geom, feat, counts,
                                                       None, **kw), reps=20)
        render_ms = time_ms(lambda: rasterize(g, cam, cfg, impl="tiled"),
                            reps=50)
    with torch.no_grad():
        bwd_ms = time_ms(lambda: composite_bwd(geom, feat, counts, None, gout,
                                               *fwd[1:], **kw), reps=200)
        bwd_plain_ms = time_ms(lambda: composite_bwd_plain(
            geom, feat, counts, None, gout, *fwd[1:], **kw), reps=10)
    nblk = fwd[2]
    with torch.no_grad():
        bound_ms, bound_by, detail, work = fwd_bound(geom, counts, nblk, None,
                                                     tiles_x, cfg)
    log(f"[6 times] {smi}: composite_fwd {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, rasterize {res}x{res} {render_ms:.4f} ms, "
        f"{launches_main} launch(es) per render")
    log(f"  bound {bound_ms:.6f} ms ({detail}), share "
        f"{bound_ms / kernel_ms:.4f} of the kernel's time; library call: none")
    bwd_bound_ms, bwd_bound_by, bwd_detail = bwd_bound(
        geom, counts, nblk, None, tiles_x, cfg, work)
    log(f"  composite_bwd {bwd_ms:.4f} ms, plain {bwd_plain_ms:.4f} ms; bound "
        f"{bwd_bound_ms:.6f} ms ({bwd_detail}), share "
        f"{bwd_bound_ms / bwd_ms:.4f} of the kernel's time; library call: none")
    # where the render's time goes: stages by CUDA events, kernels by
    # the profiler, and the device's busy share of the host's wall time
    with torch.no_grad():
        proj = project(g, cam, cfg)
        stage_ms = {
            "project": time_ms(lambda: project(g, cam, cfg), reps=50),
            "bin_and_gather_packed": time_ms(
                lambda: bin_and_gather_packed(proj, res, res, cfg), reps=50),
            "composite_fwd": kernel_ms,
        }
        n_wall = 50
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_wall):
            rasterize(g, cam, cfg, impl="tiled")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_wall
        from torch.profiler import ProfilerActivity, profile
        n_prof = 10
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_prof):
                rasterize(g, cam, cfg, impl="tiled")
            torch.cuda.synchronize()
    log("  stages (ms): " + ", ".join(f"{k} {v:.4f}"
                                      for k, v in stage_ms.items()))
    # device-side events only: a CPU op also reports its kernels' time
    events = device_rows(prof)
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3 / n_prof
    log(f"  host wall {wall_ms:.4f} ms/render, device busy {dev_ms:.4f} "
        f"ms/render (profiler), idle share {1 - dev_ms / wall_ms:.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"    {e.self_device_time_total / 1e3 / n_prof:8.4f} ms "
            f"x{e.count // n_prof:<3d} {e.key[:90]}")

    # the train step at the bench width: the step function the Trainer
    # runs, on the Trainer's state
    step_fn, st = make_train_step(cfg_train, "tiled"), trainer.state
    cam_t = cam
    tgt = torch.zeros((res, res, 3), device=dev)

    def train_step():
        nonlocal st
        st, _ = step_fn(st, cam_t, tgt)

    step_ms = time_ms(train_step, reps=N_TRAIN_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_TRAIN_STEPS):
        train_step()
    torch.cuda.synchronize()
    step_wall_ms = (time.perf_counter() - t0) * 1e3 / N_TRAIN_STEPS
    n_prof = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            train_step()
        torch.cuda.synchronize()
    events = device_rows(prof)
    step_dev_ms = sum(e.self_device_time_total for e in events) / 1e3 / n_prof
    n_kern = sum(e.count for e in events) // n_prof
    log(f"  train step {res}x{res}: {step_ms:.4f} ms (CUDA events), host "
        f"wall {step_wall_ms:.4f} ms, device busy {step_dev_ms:.4f} ms "
        f"(profiler, {n_kern} kernels/step), idle share "
        f"{1 - step_dev_ms / step_wall_ms:.3f}; "
        f"{BENCH_GAUSSIANS / (step_wall_ms / 1e3):.1f} gaussians/s fwd+bwd+Adam")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3 / n_prof:8.4f} ms "
            f"x{e.count // n_prof:<4d} {e.key[:90]}")

    # 7. the rollout path
    roll = rollout(dev, smi)
    # 8. the policy stage
    pol = policy(dev, smi)
    # 9. the articulation toolchain (no compositing kernel on its path)
    articulation(dev, smi)
    # 10. mesh to URDF: segmentation and the mask model (none either)
    segment(dev, smi)
    # 11. training's leftovers and the batched composite
    left = leftovers(dev, smi)
    # 12. the multi-device paths: world 1 over NCCL, two ranks over gloo
    multi = multidevice(dev, smi)
    # 13. the JAX package's 3M-Gaussian 512x512 config
    feas = feasibility(dev, smi)
    # 14. the unpacked binner, profile_stages, k_equiv and the 1M staged
    # config
    meas = measure(dev, smi)
    # 15. the at-scale runs: the flagship, the feature arms, the 2-DOF
    # policy
    big = at_scale(dev, smi)
    # 16. the last runs: the Gaussian-only rollout frame and its gates, the
    # cover statistics, the ring at scale, the multi-process rehearsal,
    # the mask model's trainer
    last = last_runs(dev, smi)
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    log(json.dumps({"kernels": [{
        "name": "composite_fwd", "route": "cuda",
        "source": "robosimgs_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "robosimgs_tpu/render/pallas_kernels.py:138",
        "launches": launches_train[0], "max_abs_err": max(
            err_a, err_b, err_cli, err_skip, roll["max_abs_err"],
            pol["max_abs_err"], left["batch_max_abs_err"],
            left["tile32_fwd_max_abs_err"], multi["fwd_max_abs_err"],
            feas["fwd_max_abs_err"], meas["unpacked_max_abs_err"],
            meas["staged_fwd_max_abs_err"], meas["lossless_fwd_max_abs_err"],
            big["fwd_max_abs_err"], big["policy_max_abs_err"],
            last["gsonly_max_abs_err"], last["gsonly_lossless_max_abs_err"],
            last["gsonly_batch_max_abs_err"], last["ring1m_max_abs_err"]),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "rollout_launches": roll["launches"], "rollout_ms": roll["ms"],
        "rollout_plain_ms": roll["plain_ms"],
        "rollout_bound_ms": roll["bound_ms"],
        "rollout_bound_by": roll["bound_by"],
        "closed_loop_launches": pol["launches"],
        "closed_loop_max_abs_err": pol["max_abs_err"],
        "closed_loop_ms": pol["ms"], "closed_loop_plain_ms": pol["plain_ms"],
        "closed_loop_bound_ms": pol["bound_ms"],
        "closed_loop_bound_by": pol["bound_by"],
        "batch_launches": left["batch_launches"],
        "batch_ms": left["batch_ms"], "batch_plain_ms": left["batch_plain_ms"],
        "batch_bound_ms": left["batch_bound_ms"],
        "batch_max_abs_err": left["batch_max_abs_err"],
        "graph_launches_per_step":
            left["graph_launches_per_step"]["composite_fwd"],
        "sharded_launches": multi["launches"][0],
        "sharded_max_abs_err": multi["fwd_max_abs_err"],
        "tile32_ms": left["tile32_fwd_ms"],
        "tile32_plain_ms": left["tile32_fwd_plain_ms"],
        "tile32_bound_ms": left["tile32_fwd_bound_ms"],
        "tile32_bound_by": left["tile32_fwd_bound_by"],
        "tile32_max_abs_err": left["tile32_fwd_max_abs_err"],
        "tile32_skipped_share": left["tile32_fwd_skipped_share"],
        "feasibility_launches": feas["launches"][0],
        "feasibility_ms": feas["fwd_ms"],
        "feasibility_plain_ms": feas["fwd_plain_ms"],
        "feasibility_bound_ms": feas["fwd_bound_ms"],
        "feasibility_bound_by": feas["fwd_bound_by"],
        "feasibility_max_abs_err": feas["fwd_max_abs_err"],
        "feasibility_skipped_share": feas["fwd_skipped_share"],
        "unpacked_max_abs_err": meas["unpacked_max_abs_err"],
        "staged_launches": meas["staged_launches"][0],
        "staged_ms": meas["staged_fwd_ms"],
        "staged_plain_ms": meas["staged_fwd_plain_ms"],
        "staged_bound_ms": meas["staged_fwd_bound_ms"],
        "staged_bound_by": meas["staged_fwd_bound_by"],
        "staged_max_abs_err": meas["staged_fwd_max_abs_err"],
        "lossless_K": meas["lossless_K"],
        "lossless_ms": meas["lossless_fwd_ms"],
        "lossless_bound_ms": meas["lossless_fwd_bound_ms"],
        "lossless_bound_by": meas["lossless_fwd_bound_by"],
        "lossless_half_ms": meas["lossless_half_ms"],
        "lossless_half_plain_ms": meas["lossless_half_plain_ms"],
        "lossless_max_abs_err": meas["lossless_fwd_max_abs_err"],
        "flagship_launches": big["launches"][0],
        "flagship_ms": big["fwd_ms"], "flagship_plain_ms": big["fwd_plain_ms"],
        "flagship_bound_ms": big["fwd_bound_ms"],
        "flagship_bound_by": big["fwd_bound_by"],
        "flagship_max_abs_err": big["fwd_max_abs_err"],
        "policy2dof_launches": big["policy_launches"],
        "policy2dof_ms": big["policy_ms"],
        "policy2dof_plain_ms": big["policy_plain_ms"],
        "policy2dof_bound_ms": big["policy_bound_ms"],
        "policy2dof_bound_by": big["policy_bound_by"],
        "policy2dof_max_abs_err": big["policy_max_abs_err"],
        "gsonly_launches": last["launches"],
        "gsonly_launches_per_frame": [last["frame"]["seq4_launches"],
                                      last["frame"]["batched4_launches"]],
        **{f"{p}_{k}": last[f"{p}_{k}"]
           for p in ("gsonly", "gsonly_lossless", "gsonly_batch", "ring1m")
           for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                     "max_abs_err")},
        "ring1m_launches": last["ring_launches"][0]}, {
        "name": "composite_bwd", "route": "cuda",
        "source": "robosimgs_tpu_torch/csrc/composite_bwd.cu",
        "replaces": "robosimgs_tpu/render/pallas_kernels.py:221",
        "launches": launches_train[1], "max_abs_err": max(
            err_bwd, err_32, left["tile32_max_abs_err"],
            multi["bwd_max_abs_err"], feas["bwd_max_abs_err"],
            meas["staged_bwd_max_abs_err"], big["bwd_max_abs_err"],
            last["ring1m_bwd_max_abs_err"]),
        "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by, "library_ms": None,
        "tile32_K": left["tile32_K"], "tile32_ms": left["tile32_ms"],
        "tile32_max_abs_err": max(err_32, left["tile32_max_abs_err"]),
        "tile32_plain_ms": left["tile32_plain_ms"],
        "tile32_bound_ms": left["tile32_bound_ms"],
        "tile32_bound_by": left["tile32_bound_by"],
        "graph_launches_per_step":
            left["graph_launches_per_step"]["composite_bwd"],
        "sharded_launches": multi["launches"][1],
        "sharded_max_abs_err": multi["bwd_max_abs_err"],
        "tile32_splits": left["tile32_splits"],
        "feasibility_launches": feas["launches"][1],
        "feasibility_splits": feas["splits"],
        "feasibility_ms": feas["bwd_ms"],
        "feasibility_plain_ms": feas["bwd_plain_ms"],
        "feasibility_bound_ms": feas["bwd_bound_ms"],
        "feasibility_bound_by": feas["bwd_bound_by"],
        "feasibility_max_abs_err": feas["bwd_max_abs_err"],
        "staged_launches": meas["staged_launches"][1],
        "staged_ms": meas["staged_bwd_ms"],
        "staged_plain_ms": meas["staged_bwd_plain_ms"],
        "staged_bound_ms": meas["staged_bwd_bound_ms"],
        "staged_bound_by": meas["staged_bwd_bound_by"],
        "staged_max_abs_err": meas["staged_bwd_max_abs_err"],
        "flagship_launches": big["launches"][1],
        "flagship_ms": big["bwd_ms"], "flagship_plain_ms": big["bwd_plain_ms"],
        "flagship_bound_ms": big["bwd_bound_ms"],
        "flagship_bound_by": big["bwd_bound_by"],
        "flagship_max_abs_err": big["bwd_max_abs_err"],
        "ring1m_launches": last["ring_launches"][1],
        **{f"ring1m_{k}": last[f"ring1m_bwd_{k}"]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                     "max_abs_err")}}]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


# phase 15's depth: steps of the flagship (the 601st logs step 600),
# steps of each feature arm, and the 2-DOF policy's episodes, policy
# steps and closed-loop episodes
FLAGSHIP_STEPS = 601
AB_STEPS = 100
POLICY_EPISODES, POLICY_STEPS, POLICY_EVAL = 8, 500, 2


def at_scale(dev, smi: str) -> dict:
    """Phase 15: the repo's at-scale runs through the port's tools, at
    full width and short depth. (a) tools/flagship.py: the 48 mesh-raster
    targets at 512x512 (zero truncation asserted), the Trainer with the
    7,000-step schedule run FLAGSHIP_STEPS steps across the densify
    rounds at 480 and 600: every log line's loss, PSNR, alive count and
    `overflow` (and, by one more binning of that state on that step's
    view, its overflowed tiles and truncated Gaussians), one launch of
    each kernel a step, the step's host wall, CUDA events, peak memory
    and the device's idle share over 10 profiled steps, held-out PSNR;
    then both kernels against their plain versions on the trained state
    at the flagship shape (T 1,024, P 256, K 2,048), timed and bounded.
    (b) tools/ab_features.py: each of the seven arms AB_STEPS steps at
    512x512, 24 views, capacity 100,000: finite loss, held-out PSNR above
    the initial pool's, ms a step. (c) tools/policy_multidof.py:
    POLICY_EPISODES episodes of 36 frames (one forward launch a frame),
    POLICY_STEPS policy steps (the loss falls), POLICY_EVAL closed-loop
    episodes at 50 DDIM steps; frames/s, ms a policy step, s an episode;
    the forward against its plain version at that frame's shape (T 16,
    K 256, the meshes' depth limit), timed and bounded. Returns the
    numbers of the kernels line."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from robosimgs_tpu_torch.core.camera import Camera
    from robosimgs_tpu_torch.core.types import Gaussians
    from robosimgs_tpu_torch.render.binning import bin_and_gather_packed
    from robosimgs_tpu_torch.render.compose import merge_mesh_layers
    from robosimgs_tpu_torch.render.gathered import tile_image
    from robosimgs_tpu_torch.render.kernels import (composite_bwd,
                                                    composite_bwd_plain,
                                                    composite_fwd,
                                                    composite_fwd_plain)
    from robosimgs_tpu_torch.render.mesh_raster import rasterize_mesh
    from robosimgs_tpu_torch.render.project import project
    from robosimgs_tpu_torch.render.rasterize import rasterize
    from robosimgs_tpu_torch.render.tiles import num_tiles
    from robosimgs_tpu_torch.tools import ab_features, flagship
    from robosimgs_tpu_torch.tools import policy_multidof as pm
    from robosimgs_tpu_torch.tools.workloads import time_ms
    from robosimgs_tpu_torch.train.trainer import make_train_step

    t15 = time.perf_counter()
    # 15a. the flagship at full width
    t0 = time.perf_counter()
    scene, frames = flagship.build_scene(11, 48, 512, device=dev)
    torch.cuda.synchronize()
    scene_s = time.perf_counter() - t0
    trainer, n_init = flagship.make_trainer(iters=7000, device=dev,
                                            frames=frames, scene=scene)
    cfg = trainer.cfg.render
    res = frames[0].camera.width
    log(f"[15 at scale] {smi}: flagship {len(frames)} mesh-raster targets "
        f"{res}x{res} in {scene_s:.2f} s (zero truncated triangles and "
        f"overflowed tiles); {len(trainer.frames)} train / "
        f"{len(trainer.eval_frames)} held out, {n_init} initial points in a "
        f"{trainer.state.gaussians.capacity} pool, K={cfg.tile_capacity}, "
        f"M={cfg.max_tiles_per_gaussian}")
    binned = []

    def on_log(m):
        # the step's view binned once more on the state after the step
        cam = trainer.frames[m["step"] % len(trainer.frames)].camera
        with torch.no_grad():
            st = bin_and_gather_packed(
                project(trainer.state.gaussians, cam, cfg),
                res, res, cfg)[3]
        binned.append((int(st.overflowed_tiles),
                       int(st.truncated_gaussians)))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    composite_fwd.launches = composite_bwd.launches = 0
    t0 = time.perf_counter()
    trainer.run(iterations=FLAGSHIP_STEPS, progress=False, on_log=on_log)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = (composite_fwd.launches, composite_bwd.launches)
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    for h, (over, trunc) in zip(hist, binned):
        log(f"  step {h['step']:4d}: loss {h['loss']:.6f} psnr "
            f"{h['psnr']:.4f} alive {int(h['n_alive'])} overflow "
            f"{int(h['overflow'])} (that state on that view: {over} tiles "
            f"past K, {trunc} truncated Gaussians)")
    alive = int(trainer.state.gaussians.num_alive)
    log(f"  {FLAGSHIP_STEPS} steps in {run_s:.2f} s host wall "
        f"({run_s / FLAGSHIP_STEPS * 1e3:.4f} ms a step, "
        f"{FLAGSHIP_STEPS / run_s:.4f} it/s, with {len(hist)} log lines' "
        f"extra binning), launches {launches}, peak memory "
        f"{peak / 2**30:.3f} GiB ({peak} B), alive after the densify rounds "
        f"{alive}")
    # the step alone: CUDA events and host wall on a copy of the state,
    # and the device's idle share over 10 profiled steps
    step_fn, st = make_train_step(trainer.cfg, trainer.impl), trainer.state
    tgt = torch.from_numpy(trainer.frames[0].image).to(dev)
    cam0 = trainer.frames[0].camera

    def train_step():
        nonlocal st
        st, _ = step_fn(st, cam0, tgt)

    step_ms = time_ms(train_step, reps=20, warmup=2)
    step_wall = wall_ms(train_step, 20)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            train_step()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    busy, summed, n_ops = trace_busy(prof)
    log(f"  the step: {step_ms:.4f} ms (CUDA events, 20 steps), host wall "
        f"{step_wall:.4f} ms; 10 profiled steps {prof_wall:.2f} ms wall, "
        f"device busy {busy:.2f} ms (union; {summed:.2f} ms summed over "
        f"{n_ops} operations), idle share {1 - busy / prof_wall:.4f} of the "
        f"profiled wall, {1 - busy / 10 / step_wall:.4f} of the unprofiled "
        f"host wall")
    ops = device_ops(prof, 10, "flagship train step")
    del st
    eval_psnr = trainer.eval_psnr()
    first, last = hist[0], hist[-1]
    log(f"  held-out PSNR after {FLAGSHIP_STEPS} steps: {eval_psnr:.4f} dB; "
        f"train PSNR step {first['step']} {first['psnr']:.4f} -> step "
        f"{last['step']} {last['psnr']:.4f} (the JAX package's history: "
        f"14.10 -> 27.14 at the same steps)")
    if not all(np.isfinite(h["loss"]) for h in hist):
        raise AssertionError("the flagship loss is not finite")
    if last["psnr"] < first["psnr"] + 6.0:
        raise AssertionError("the flagship's PSNR rose less than 6 dB")
    if alive <= 20_000:
        raise AssertionError(f"{alive} alive after the densify rounds")
    if launches != (FLAGSHIP_STEPS, FLAGSHIP_STEPS):
        raise AssertionError(f"flagship launches {launches}, not one of "
                             "each kernel a step")

    # both kernels against their plain versions on the trained state, at
    # the flagship shape (the first training view)
    with torch.no_grad():
        geom, feat, counts, stats = bin_and_gather_packed(
            project(trainer.state.gaussians, cam0, cfg), res, res, cfg)
        T, K = geom.shape[0], geom.shape[2]
        tx = num_tiles(res, res, cfg.tile_size)[0]
        kw = dict(tiles_x=tx, cfg=cfg, has_dlim=False)
        fwd = composite_fwd(geom, feat, counts, None, **kw)
        torch.cuda.synchronize()
        log(f"  flagship blocks: T={T} P={cfg.tile_size ** 2} K={K} f32, "
            f"{int(stats.overflowed_tiles)} tiles past K, max tile count "
            f"{int(stats.max_tile_count)}, {int(stats.total_pairs)} pairs; "
            f"{nblk_histogram(fwd[2])}")
        fwd_err = compare_fwd(fwd, composite_fwd_plain(
            geom, feat, counts, None, **kw), "flagship",
            (geom, counts, None, kw))[0]
        gout = torch.randn(fwd[0].shape, generator=torch.Generator()
                           .manual_seed(15)).to(dev)
        args = (geom, feat, counts, None, gout, *fwd[1:])
        bwd_err = compare_bwd(composite_bwd(*args, **kw),
                              composite_bwd_plain(*args, **kw),
                              "bwd flagship")
        fwd_ms = time_ms(lambda: composite_fwd(geom, feat, counts, None,
                                               **kw), reps=100)
        fwd_plain_ms = time_ms(lambda: composite_fwd_plain(
            geom, feat, counts, None, **kw), reps=2, warmup=1)
        bwd_ms = time_ms(lambda: composite_bwd(*args, **kw), reps=100)
        bwd_plain_ms = time_ms(lambda: composite_bwd_plain(*args, **kw),
                               reps=2, warmup=1)
        fb_ms, fb_by, fb_detail, work = fwd_bound(geom, counts, fwd[2], None,
                                                  tx, cfg)
        bb_ms, bb_by, bb_detail = bwd_bound(geom, counts, fwd[2], None, tx,
                                            cfg, work)
    log(f"  composite_fwd {fwd_ms:.4f} ms, plain {fwd_plain_ms:.4f} ms; bound "
        f"{fb_ms:.6f} ms ({fb_detail}), share {fb_ms / fwd_ms:.4f}; library "
        f"call: none ({smi})")
    log(f"  composite_bwd {bwd_ms:.4f} ms, plain {bwd_plain_ms:.4f} ms; bound "
        f"{bb_ms:.6f} ms ({bb_detail}), share {bb_ms / bwd_ms:.4f}; library "
        f"call: none ({smi})")
    del trainer, frames, geom, feat, counts, fwd, gout, args
    log(f"  15a {time.perf_counter() - t15:.1f} s")

    # 15b. the seven feature arms
    t15b = time.perf_counter()
    scene, frames = flagship.build_scene(11, 24, 512, with_depth=True,
                                         device=dev)
    eval_f = flagship.holdout_split(frames, 4)[1]
    # each arm's initial pool (the same points) through its own renderer
    g0 = Gaussians.from_points(
        flagship.init_points(scene, min(8_000, 100_000 // 4)), sh_degree=2,
        capacity=100_000, device=dev)
    bg = torch.ones(3, device=dev)
    with torch.no_grad():
        psnr0 = {name: float(np.mean([psnr(rasterize(
            g0, f.camera, c.render, background=bg)["rgb"],
            torch.from_numpy(f.image).to(dev)) for f in eval_f]))
            for name, c in ab_features.arm_configs(AB_STEPS).items()}
    del g0
    composite_fwd.launches = composite_bwd.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        ab = ab_features.run(os.path.join(tmp, "ab.json"), iters=AB_STEPS,
                             frames=frames, scene=scene, device=dev,
                             progress=False)
    ab_launches = (composite_fwd.launches, composite_bwd.launches)
    for name, row in ab["arms"].items():
        log(f"  {name}: {row}; {ab['seconds'][name] / AB_STEPS * 1e3:.4f} "
            f"ms a step (host wall); held-out PSNR of its initial pool "
            f"{psnr0[name]:.4f} dB")
    log(f"  launches "
        f"{ab_launches} ({len(ab['arms'])} x {AB_STEPS} steps + "
        f"{len(eval_f)} held-out renders an arm); 15b "
        f"{time.perf_counter() - t15b:.1f} s")
    bad = [n for n, r in ab["arms"].items()
           if not np.isfinite(r["final_loss"]) or r["eval_psnr"] <= psnr0[n]]
    if bad or list(ab["arms"]) != list(ab_features.ARMS):
        raise AssertionError(f"feature arms failed: {bad}")
    del frames, scene

    # 15c. the 2-DOF policy
    t15c = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        obj = pm.write_object(tmp)
        bg = pm.background(dev)
        rng = np.random.default_rng(0)
        composite_fwd.launches = 0
        t0 = time.perf_counter()
        ds = pm.make_dataset(obj, bg, rng, POLICY_EPISODES, 36, tmp,
                             progress=False)
        data_s = time.perf_counter() - t0
        pol_launches = composite_fwd.launches
        t0 = time.perf_counter()
        tr = pm.train(ds, POLICY_STEPS, dev, progress=False)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        composite_fwd.launches = 0
        t0 = time.perf_counter()
        succ, finals = pm.closed_loop(tr, obj, bg, rng, POLICY_EVAL, 36, 50,
                                      progress=False)
        eval_s = time.perf_counter() - t0
        loop_launches = composite_fwd.launches
        # the forward against its plain version at the 2-DOF frame's shape
        # (both joints at their targets, the evaluation's camera, the
        # meshes' depth limit as render_rollout merges it)
        cam = Camera.look_at(pm.BASE_EYE, pm.CENTER, [0, 0, 1], 55.0, pm.RES,
                             pm.RES, device=dev)
        rcfg = pm.RENDER
        tx, ty = num_tiles(pm.RES, pm.RES, rcfg.tile_size)
        with torch.no_grad():
            m_out = merge_mesh_layers([
                {k: o[k] for k in ("rgb", "depth", "mask", "face_id")}
                for o in (rasterize_mesh(v, f, cam, vertex_colors=c)
                          for v, f, c in obj.posed_meshes(pm.TARGETS_Q,
                                                          device=dev))])
            geom, feat, counts, _ = bin_and_gather_packed(
                project(bg, cam, rcfg), pm.RES, pm.RES, rcfg)
            dlim = tile_image(m_out["depth"], tx, ty, rcfg.tile_size,
                              pad_value=float("inf"))[..., None].contiguous()
            kw = dict(tiles_x=tx, cfg=rcfg, has_dlim=True)
            got = composite_fwd(geom, feat, counts, dlim, **kw)
            torch.cuda.synchronize()
            pol_err = compare_fwd(got, composite_fwd_plain(
                geom, feat, counts, dlim, **kw), "2-DOF frame 64x64 mesh "
                "depth limit", (geom, counts, dlim, kw))[0]
            pol_ms = time_ms(lambda: composite_fwd(geom, feat, counts, dlim,
                                                   **kw), reps=200)
            pol_plain_ms = time_ms(lambda: composite_fwd_plain(
                geom, feat, counts, dlim, **kw), reps=10)
            pb_ms, pb_by, pb_detail, _ = fwd_bound(geom, counts, got[2], dlim,
                                                   tx, rcfg)
    log(f"  composite_fwd at the 2-DOF shape (T={geom.shape[0]}, "
        f"K={geom.shape[2]}, mesh depth limit) {pol_ms:.4f} ms, plain "
        f"{pol_plain_ms:.4f} ms; bound {pb_ms:.6f} ms ({pb_detail}), share "
        f"{pb_ms / pol_ms:.4f}; library call: none ({smi})")
    n_frames = len(ds.images)
    losses = [h["loss"] for h in tr.history]
    log(f"  2-DOF policy: {POLICY_EPISODES} episodes, {n_frames} frames "
        f"{pm.RES}x{pm.RES} in {data_s:.2f} s ({n_frames / data_s:.2f} "
        f"frames/s), forward launches {pol_launches}; {POLICY_STEPS} policy "
        f"steps {train_s / POLICY_STEPS * 1e3:.4f} ms a step (host wall), "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; {POLICY_EVAL} closed-loop "
        f"episodes {eval_s / POLICY_EVAL:.3f} s each at 50 DDIM steps, "
        f"success {succ}, final {finals}, forward launches {loop_launches}")
    if pol_launches != n_frames or n_frames != POLICY_EPISODES * 36:
        raise AssertionError(f"{pol_launches} forward launches for "
                             f"{n_frames} frames")
    if not np.isfinite(ds.images).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"the 2-DOF policy did not train: {losses}")
    if loop_launches != POLICY_EVAL * 37:
        raise AssertionError(f"{loop_launches} closed-loop forward launches")
    log(f"  15c {time.perf_counter() - t15c:.1f} s; phase 15 "
        f"{time.perf_counter() - t15:.1f} s")
    return dict(launches=launches, fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain_ms,
                fwd_bound_ms=fb_ms, fwd_bound_by=fb_by,
                fwd_max_abs_err=fwd_err, bwd_ms=bwd_ms,
                bwd_plain_ms=bwd_plain_ms, bwd_bound_ms=bb_ms,
                bwd_bound_by=bb_by, bwd_max_abs_err=bwd_err,
                policy_launches=pol_launches, policy_ms=pol_ms,
                policy_plain_ms=pol_plain_ms, policy_bound_ms=pb_ms,
                policy_bound_by=pb_by, policy_max_abs_err=pol_err,
                step_ms=step_ms, transpose_ms=ops["transpose_ms"])


# phase 16's depth: iterations of each timed rollout frame, the ring's
# Gaussians (every rank's two steps at each), its render law's worlds and
# Gaussians, and the mask model's steps
GS_FRAME_ITERS = 5
RING_NS = (524_288, 1_048_576)
LAW_WORLDS, LAW_NS = (2, 4, 8), (131_072, 1_048_576)
MASKNET_STEPS = 50


def last_runs(dev, smi: str) -> dict:
    """Phase 16: the repo's last runs that need no reference files,
    through the port's tools. (a) tools/profile_rollout.py on the
    Gaussian-only rollout frame (200k Gaussians, four 640x480 cameras,
    no mesh) at GS_FRAME_ITERS iterations, with the rollout config as a
    variant: the stage split on camera 0, one camera / four sequential /
    one batched frame (one forward launch a camera, one a batch), every
    camera at M 64 over an 84-tile bbox without truncation, K 2,048 /
    1,024 / 512 and (tools/rollout_gate384.py) 384 each >= 60 dB against
    K 8,192, the r4 config (M 12) truncating; the forward against its
    plain version at K 512 and K 8,192 on camera 0 and batched, timed and
    bounded. (b) tools/staged_cover_stats.py on the rollout draw's four
    cameras: the demand sums to the pairs and M 64 / bbox 84 cover the
    maxima. (c) tools/ring_at_scale.py: 8 gloo ranks on the card, the
    ring and the all_gather step at each of RING_NS (finite losses, ring
    loss0 within 1e-6 and loss1 within 1e-5 relative of all_gather's,
    one launch of each kernel a step, each rank's peak bytes), the render
    law at LAW_WORLDS x LAW_NS, both kernels against their plain versions
    on rank 0's merged ring blocks at the largest N, timed and bounded.
    (d) tools/multihost_rehearsal.py: 8 ranks on a (2, 4) mesh, every
    loss equal to the single-process loss. (e) tools/train_masknet.py:
    MASKNET_STEPS steps at 96 px (the loss falls, the IoU is finite).
    Returns the numbers of the kernels line."""
    import numpy as np
    import torch

    from robosimgs_tpu_torch.render.binning import bin_and_gather_packed
    from robosimgs_tpu_torch.render.kernels import (composite_bwd,
                                                    composite_bwd_plain,
                                                    composite_fwd,
                                                    composite_fwd_plain)
    from robosimgs_tpu_torch.render.project import project
    from robosimgs_tpu_torch.render.tiles import num_tiles
    from robosimgs_tpu_torch.tools import multihost_rehearsal as mh
    from robosimgs_tpu_torch.tools import profile_rollout as pr
    from robosimgs_tpu_torch.tools import ring_at_scale as ras
    from robosimgs_tpu_torch.tools import rollout_gate384
    from robosimgs_tpu_torch.tools import staged_cover_stats as scs
    from robosimgs_tpu_torch.tools import train_masknet as tmk
    from robosimgs_tpu_torch.tools.workloads import rollout_scene, time_ms

    t16 = time.perf_counter()
    out = {}

    def held(name, geom, feat, counts, kw, tag, reps=50):
        """The forward against its plain version on these blocks, its
        time, its plain version's and its bound (kernels-line keys
        prefixed with name)."""
        fwd = composite_fwd(geom, feat, counts, None, **kw)
        torch.cuda.synchronize()
        log(f"  {tag}: T={geom.shape[0]} K={geom.shape[2]}; "
            f"{nblk_histogram(fwd[2])}")
        err = compare_fwd(fwd, composite_fwd_plain(geom, feat, counts, None,
                                                   **kw), tag,
                          (geom, counts, None, kw))[0]
        ms = time_ms(lambda: composite_fwd(geom, feat, counts, None, **kw),
                     reps=reps)
        plain = time_ms(lambda: composite_fwd_plain(geom, feat, counts, None,
                                                    **kw), reps=2, warmup=1)
        b_ms, b_by, detail, work = fwd_bound(
            geom, counts, fwd[2], None, kw["tiles_x"], kw["cfg"],
            kw.get("n_tiles_per_image", 0))
        log(f"  composite_fwd {ms:.4f} ms, plain {plain:.4f} ms; bound "
            f"{b_ms:.6f} ms ({detail}), share {b_ms / ms:.4f}; library "
            f"call: none ({smi})")
        out.update({f"{name}_max_abs_err": err, f"{name}_ms": ms,
                    f"{name}_plain_ms": plain, f"{name}_bound_ms": b_ms,
                    f"{name}_bound_by": b_by})
        return fwd, work

    # 16a. the Gaussian-only rollout frame
    t0 = time.perf_counter()
    g, cams, rcfg = rollout_scene(dev)
    W, H = cams[0].width, cams[0].height
    tx, ty = num_tiles(W, H, rcfg.tile_size)
    variants = pr.parse_variants(
        f"rollout_K{rcfg.tile_capacity},k={rcfg.tile_capacity},"
        f"m={rcfg.max_tiles_per_gaussian},bbox={rcfg.bbox_tiles_per_gaussian}"
        f",split={rcfg.two_tier_split},frac={rcfg.two_tier_spill_frac!r}")
    vname = f"rollout_K{rcfg.tile_capacity}"
    log(f"[16 last runs] {smi}: (a) tools/profile_rollout.py, "
        f"{g.capacity} Gaussians, {len(cams)} x {W}x{H}, no mesh; variants "
        f"{list(variants)}")
    composite_fwd.launches = 0
    prof = pr.profile_rollout(g, cams, variants, iters=GS_FRAME_ITERS,
                              log=lambda line: log("  " + line))
    torch.cuda.synchronize()
    out["launches"] = composite_fwd.launches
    gate = prof.pop("gate")
    del gate["rgb"]
    g384 = rollout_gate384.gate384(g, cams[0])
    del g384["rgb"]
    log(f"  GATE K=384 (m=64) vs K=8192: {g384['gate_K384_dB']:.4f} dB, "
        f"truncated {g384['truncated']}; profile_rollout "
        f"{time.perf_counter() - t0:.1f} s, forward launches "
        f"{out['launches']}")
    frame = prof[vname]
    if (frame["one_cam_launches"], frame["seq4_launches"],
            frame["batched4_launches"]) != (1, len(cams), 1):
        raise AssertionError(f"frame launches {frame}")
    dbs = {k: prof[f"gate_K{k}_dB"] for k in pr.GATE_KS}
    dbs[384] = g384["gate_K384_dB"]
    low = {k: v for k, v in dbs.items() if not v >= 60.0}
    if low:
        raise AssertionError(f"rollout capacity gates below 60 dB: {low}")
    lossless = {**gate["truncated"], **g384["truncated"]}
    if any(v for k, v in lossless.items() if k != "r4") \
            or not gate["truncated"]["r4"] > 0:
        raise AssertionError(f"truncation at M 64 / the r4 config: "
                             f"{lossless}")
    m64 = [variants[vname], pr.mkcfg(512, pr.GATE_M, pr.GATE_BBOX)]
    with torch.no_grad():
        per_cam = [[int(bin_and_gather_packed(project(g, c, cfg), W, H,
                                              cfg)[3].truncated_gaussians)
                    for cfg in m64] for c in cams]
    log(f"  truncated Gaussians per camera at M 64 over an 84-tile bbox "
        f"(rollout config, one tier): {per_cam}; r4 on camera 0: "
        f"{gate['truncated']['r4']} ({prof['r4_lossy_dB']:.4f} dB)")
    if any(any(row) for row in per_cam):
        raise AssertionError("an M-64 config truncates on some camera")
    out["frame"] = frame
    # the forward against its plain version on this frame's blocks
    kw = dict(tiles_x=tx, cfg=variants[vname], has_dlim=False)
    with torch.no_grad():
        blocks = [bin_and_gather_packed(project(g, c, kw["cfg"]), W, H,
                                        kw["cfg"])[:3] for c in cams]
        held("gsonly", *blocks[0], kw, f"{vname} camera 0, no depth limit")
        lcfg = pr.mkcfg(pr.K_LOSSLESS, pr.GATE_M, pr.GATE_BBOX, chunk=512)
        kw_l = dict(tiles_x=tx, cfg=lcfg, has_dlim=False)
        lossless_blocks = bin_and_gather_packed(project(g, cams[0], lcfg), W,
                                                H, lcfg)[:3]
        held("gsonly_lossless", *lossless_blocks, kw_l,
             f"K{pr.K_LOSSLESS} camera 0, no depth limit", reps=20)
        del lossless_blocks
        kw_b = dict(kw, n_tiles_per_image=tx * ty)
        held("gsonly_batch", *(torch.cat([b[i] for b in blocks])
                               for i in range(3)), kw_b,
             f"{vname} batched, {len(cams)} cameras", reps=20)
    del blocks
    log(f"  16a {time.perf_counter() - t16:.1f} s")

    # 16b. the rollout draw's covers
    t0 = time.perf_counter()
    cov = scs.rollout_cover_stats(g, cams)
    for r, v in enumerate(cov["views"]):
        log(f"  (b) camera {r}: max bbox cover {v['max_bbox_cover']}, max "
            f"survivor cover {v['max_survivor_cover']}, percentiles "
            f"{v['cover_percentiles']}, pairs {v['total_true_pairs']}, max "
            f"tile demand {v['max_tile_demand']} (mean "
            f"{v['mean_tile_demand']:.1f}, p99 {v['p99_tile_demand']}), past "
            f"the split {v['rows_over_split']}, best two-tier "
            f"{v['two_tier_lossless'][:2]}")
    log(f"  maxima over the cameras: bbox {cov['max_bbox_cover']} (config "
        f"{rcfg.bbox_tiles_per_gaussian}), survivor "
        f"{cov['max_survivor_cover']} (M {rcfg.max_tiles_per_gaussian}), "
        f"tile demand {cov['max_tile_demand']}; "
        f"{time.perf_counter() - t0:.1f} s")
    if cov["max_survivor_cover"] > rcfg.max_tiles_per_gaussian \
            or cov["max_bbox_cover"] > rcfg.bbox_tiles_per_gaussian:
        raise AssertionError("the rollout config's M / bbox miss the draw")
    del g, cams
    torch.cuda.empty_cache()

    # 16c. the ring at scale: 8 gloo ranks on the card
    t0 = time.perf_counter()
    ring = ras.ring_at_scale("cuda", ns=RING_NS, law_worlds=LAW_WORLDS,
                             law_ns=LAW_NS, log=lambda line: log("  " + line))
    rows = {(r["n"], r["gather"]): r for r in ring["executed_steps"]}
    ring_launches = [0, 0]
    for n in RING_NS:
        a, b = rows[(n, "all_gather")], rows[(n, "ring")]
        e0 = abs(b["loss0"] - a["loss0"]) / abs(a["loss0"])
        e1 = abs(b["loss1"] - a["loss1"]) / abs(a["loss1"])
        log(f"  (c) N {n}: ring loss {b['loss0']:.8f} -> {b['loss1']:.8f}, "
            f"all_gather {a['loss0']:.8f} -> {a['loss1']:.8f} (rel "
            f"{e0:.3e}, {e1:.3e}); steady step {b['steady_s']:.3f} / "
            f"{a['steady_s']:.3f} s; peak step bytes a rank ring "
            f"{max(b['step_bytes'])}, all_gather {max(a['step_bytes'])}")
        if not all(np.isfinite([a["loss0"], a["loss1"], b["loss0"],
                                b["loss1"]])) or e0 > 1e-6 or e1 > 1e-5:
            raise AssertionError(f"the ring at N {n} differs from all_gather")
        for row in (a, b):
            if any(list(x) != [2, 2] for x in row["launches"]):
                raise AssertionError(f"ring_at_scale launches {row}")
            for x in row["launches"]:
                ring_launches[0] += x[0]
                ring_launches[1] += x[1]
    for row in ring["render_path_peak_bytes_per_rank"]:
        log(f"  render law world {row['devices']} N {row['n']}: peak bytes "
            f"a rank ring {max(row['ring_peak_bytes'])}, all_gather "
            f"{max(row['all_gather_peak_bytes'])}")
    log(f"  ring_at_scale {time.perf_counter() - t0:.1f} s")
    out["ring_launches"] = ring_launches
    # both kernels on rank 0's merged blocks at the largest N
    rb = ring["blocks"]
    cfg_r = ras.train_config().render
    geom, feat = (torch.from_numpy(rb[k]).to(dev) for k in ("geom", "feat"))
    counts = torch.from_numpy(rb["counts"]).to(dev)
    kw_r = dict(tiles_x=num_tiles(ras.RES, ras.RES, cfg_r.tile_size)[0],
                cfg=cfg_r, has_dlim=False)
    with torch.no_grad():
        fwd, work = held("ring1m", geom, feat, counts, kw_r,
                         f"ring merged blocks at N {rb['n']} (rank 0)",
                         reps=200)
        gout = torch.randn(fwd[0].shape, generator=torch.Generator()
                           .manual_seed(16)).to(dev)
        args = (geom, feat, counts, None, gout, *fwd[1:])
        out["ring1m_bwd_max_abs_err"] = compare_bwd(
            composite_bwd(*args, **kw_r), composite_bwd_plain(*args, **kw_r),
            "bwd on the ring's merged blocks")
        out["ring1m_bwd_ms"] = time_ms(lambda: composite_bwd(*args, **kw_r),
                                       reps=200)
        out["ring1m_bwd_plain_ms"] = time_ms(
            lambda: composite_bwd_plain(*args, **kw_r), reps=5)
        bb_ms, bb_by, bb_detail = bwd_bound(geom, counts, fwd[2], None,
                                            kw_r["tiles_x"], cfg_r, work)
    out["ring1m_bwd_bound_ms"], out["ring1m_bwd_bound_by"] = bb_ms, bb_by
    log(f"  composite_bwd {out['ring1m_bwd_ms']:.4f} ms, plain "
        f"{out['ring1m_bwd_plain_ms']:.4f} ms; bound {bb_ms:.6f} ms "
        f"({bb_detail}), share {bb_ms / out['ring1m_bwd_ms']:.4f}; library "
        f"call: none ({smi})")

    # 16d. the multi-process rehearsal
    t0 = time.perf_counter()
    mh_res = mh.rehearse(*mh.build_problem("cpu"), device="cuda")
    ref = mh_res["single_process_loss"]
    log(f"  (d) multihost_rehearsal: {mh_res['processes']} ranks over "
        f"{mh_res['backend']}, mesh {mh_res['mesh']}: losses "
        f"{sorted(set(mh_res['losses']))}, single process {ref:.8f} (max "
        f"rel {max(abs(x - ref) for x in mh_res['losses']) / abs(ref):.3e}"
        f", bound {mh.RTOL}), data rows outermost "
        f"{mh_res['data_rows_outermost']}; {time.perf_counter() - t0:.1f} s")
    if not mh_res["match"]:
        raise AssertionError("a rank's loss differs from one process's")

    # 16e. the mask model's trainer
    t0 = time.perf_counter()
    mk = tmk.run(MASKNET_STEPS, 96, device=dev, log=lambda line: log(
        "  " + line) if not line.startswith("scene ") else None)
    first, last = (float(np.mean(mk["losses"][s])) for s in (
        slice(0, 10), slice(-10, None)))
    log(f"  (e) train_masknet {MASKNET_STEPS} steps at 96 px: loss (mean of "
        f"10) {first:.4f} -> {last:.4f}, held-out IoU "
        f"{mk['holdout_iou']:.4f} (checked-in weights "
        f"{mk['checked_in_holdout_iou']:.4f}), fresh-scene best IoU "
        f"{mk['mean_best_iou']:.4f}; {time.perf_counter() - t0:.1f} s")
    if not last < first or not np.isfinite(mk["holdout_iou"]):
        raise AssertionError("the mask model did not train")
    log(f"  phase 16 {time.perf_counter() - t16:.1f} s")
    return out


def multidevice(dev, smi: str) -> dict:
    """Phase 12: the multi-device paths (parallel/) on the one card.
    (a) world size 1 over NCCL in this process, mesh (1, 1), the bench
    workload: the DP step, the gaussian-sharded step with the all_gather
    and with the ring, each against make_train_step on the same camera
    (loss and gradients within 1e-6 of the largest; the gradients read
    from Adam's first moments, (1 - b1) g after one step from zero), its
    ms (CUDA events), host wall and kernels a step (profiler: one
    composite_fwd and one composite_bwd); render_rollout(camera_mesh=)
    on the rollout workload (2 steps) bit-equal to the unsharded frames;
    cli.render_rollout --shard-cameras without a launcher writing the
    unsharded CLI's PNGs. (b) two ranks over gloo sharing the card (tools/dist_run.py): the DP
    step over 2 cameras against (a)'s world-1 DP step on them; the ring
    over 2 shards of 50k Gaussians at a lossless single-tier capacity,
    its merged blocks' counts bit-equal to binning the whole set, both
    kernels against their plain versions on those blocks, the ring step
    against the all_gather step; the camera-sharded rollout (2 cameras
    a rank) bit-equal to (a)'s frames; the bytes comm.py staged through
    the host. Every check raises. Returns the kernels line's numbers."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from robosimgs_tpu_torch import Camera
    from robosimgs_tpu_torch.cli import render_rollout as cli_rollout
    from robosimgs_tpu_torch.core.convert import shard_train_state
    from robosimgs_tpu_torch.parallel.distributed import (
        make_dp_train_step, make_gaussian_sharded_train_step, stack_cameras)
    from robosimgs_tpu_torch.parallel.mesh import make_mesh
    from robosimgs_tpu_torch.render.binning import bin_and_gather_packed
    from robosimgs_tpu_torch.render.kernels import (composite_bwd,
                                                    composite_bwd_plain,
                                                    composite_fwd,
                                                    composite_fwd_plain)
    from robosimgs_tpu_torch.render.project import project
    from robosimgs_tpu_torch.render.tiles import num_tiles
    from robosimgs_tpu_torch.scenegen.rollout import (ArticulatedObject,
                                                      render_rollout)
    from robosimgs_tpu_torch.scenegen.trajectory import load_trajectory
    from robosimgs_tpu_torch.tools import dist_run
    from robosimgs_tpu_torch.tools.workloads import (ROLLOUT_MESH,
                                                     bench_scene,
                                                     rollout_scene, time_ms,
                                                     write_rollout_inputs,
                                                     write_rollout_object)
    from robosimgs_tpu_torch.train.densify import DensifyState
    from robosimgs_tpu_torch.train.io_ply import save_ply
    from robosimgs_tpu_torch.train.optim import (FLOAT_FIELDS, float_params,
                                                 make_optimizer)
    from robosimgs_tpu_torch.train.trainer import (TrainConfig, TrainState,
                                                   make_train_step)
    from robosimgs_tpu_torch.utils.imresize import read_png_rgb

    t12 = time.perf_counter()
    g, cam, cfg = bench_scene(dev)
    res = cam.width
    cfg_train = TrainConfig(render=cfg, impl="tiled", sh_warmup_every=1)
    optimizer = make_optimizer(cfg_train.optim, cfg_train.scene_extent)

    def fresh(gg):
        return TrainState(gaussians=gg,
                          opt_state=optimizer.init(float_params(gg)),
                          densify_state=DensifyState.zero(gg.capacity,
                                                          device=gg.device),
                          step=0, generator=torch.Generator().manual_seed(0))

    def grad_err(got, want):
        """(max |got - want| over every gradient entry, over the largest
        |want| entry; the worst field). Fields such as the quaternions'
        sit at f32 noise on this scene, where a per-field ratio measures
        the summation order."""
        def cpu(x):
            return (x if torch.is_tensor(x) else torch.from_numpy(x)).cpu()

        d = {k: float((cpu(got[k]) - cpu(want[k])).abs().max())
             for k in FLOAT_FIELDS}
        top = max(float(cpu(want[k]).abs().max()) for k in FLOAT_FIELDS)
        worst = max(d, key=d.get)
        return d[worst] / top, worst

    state0 = fresh(g)
    tgt = torch.zeros((res, res, 3), device=dev)
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{dist_run.free_port()}",
        world_size=1, rank=0)
    try:
        # 12a. world size 1 over NCCL, mesh (1, 1)
        mesh = make_mesh(1, 1)
        ref_state, ref_m = make_train_step(cfg_train, "tiled")(state0, cam,
                                                               tgt)
        dp = make_dp_train_step(cfg_train, mesh, impl="tiled")
        gs_ag = make_gaussian_sharded_train_step(cfg_train, mesh,
                                                 impl="tiled")
        gs_ring = make_gaussian_sharded_train_step(cfg_train, mesh,
                                                   impl="tiled",
                                                   gather="ring")
        cam_b = stack_cameras([cam])
        steps = {"dp": lambda: dp(state0, cam_b, tgt[None]),
                 "all_gather": lambda: gs_ag(state0, cam, tgt),
                 "ring": lambda: gs_ring(state0, cam, tgt)}
        sharded_launches = [0, 0]
        out = {}
        log(f"[12 multi-device] (a) world 1 over NCCL, mesh (1, 1), bench "
            f"workload ({g.capacity} Gaussians, {res}x{res}, K="
            f"{cfg.tile_capacity}); make_train_step loss "
            f"{float(ref_m['loss']):.8f}")
        for name, fn in steps.items():
            composite_fwd.launches = composite_bwd.launches = 0
            new, m = fn()
            torch.cuda.synchronize()
            launches = (composite_fwd.launches, composite_bwd.launches)
            sharded_launches[0] += launches[0]
            sharded_launches[1] += launches[1]
            loss_err = abs(float(m["loss"]) - float(ref_m["loss"])) \
                / abs(float(ref_m["loss"]))
            g_err, g_worst = grad_err(
                {k: new.opt_state[k].mu for k in FLOAT_FIELDS},
                {k: ref_state.opt_state[k].mu for k in FLOAT_FIELDS})
            acc, ref_acc = (s.densify_state.grad_accum
                            for s in (new, ref_state))
            stat_err = float((acc - ref_acc).abs().max()) \
                / float(ref_acc.abs().max())
            ms = time_ms(fn, reps=10)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / 10
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
            kc = kernel_counts(prof, 3)
            log(f"  {name} step: loss {float(m['loss']):.8f}, |loss - "
                f"make_train_step's| / loss {loss_err:.3e}, gradients "
                f"max|d| / max {g_err:.3e} (worst {g_worst}), densify "
                f"grad_accum "
                f"{stat_err:.3e}; launches {launches}; {ms:.4f} ms (CUDA "
                f"events), host wall {wall:.4f} ms; kernels a step "
                f"(profiler) composite_fwd {kc['composite_fwd']:.2f} "
                f"composite_bwd {kc['composite_bwd']:.2f} ({smi})")
            if loss_err > 1e-6 or g_err > 1e-6 or stat_err > 1e-6:
                raise AssertionError(f"the {name} step differs from "
                                     "make_train_step at world 1")
            if launches != (1, 1) or kc != {"composite_fwd": 1.0,
                                            "composite_bwd": 1.0}:
                raise AssertionError(f"the {name} step launched {launches}, "
                                     f"profiled {kc}")
            out[name] = dict(ms=ms, wall_ms=wall, loss_err=loss_err,
                             grad_err=g_err)

        # the rollout workload, camera-sharded over the (1, 1) mesh
        rg, rcams, rcfg = rollout_scene(dev)
        urdf = write_rollout_object(tmp)
        obj = ArticulatedObject.from_urdf(urdf)
        traj_path, cams_path = write_rollout_inputs(tmp, obj.model, steps=2)
        traj, poses = load_trajectory(traj_path, [obj.model])
        rkw = dict(cfg=rcfg, mesh_cfg=ROLLOUT_MESH, base_poses=poses)
        composite_fwd.launches = composite_bwd.launches = 0
        t0 = time.perf_counter()
        frames = render_rollout(rg, [obj], traj, rcams, camera_mesh=mesh,
                                **rkw)
        torch.cuda.synchronize()
        roll_s = time.perf_counter() - t0
        roll_launches = (composite_fwd.launches, composite_bwd.launches)
        sharded_launches[0] += roll_launches[0]
        plain_frames = render_rollout(rg, [obj], traj, rcams, **rkw)
        log(f"  render_rollout(camera_mesh=(1, 1)): 2 steps x {len(rcams)} "
            f"cameras {rcams[0].width}x{rcams[0].height} in {roll_s:.2f} s, "
            f"launches {roll_launches}; bit-equal to the unsharded frames: "
            f"{np.array_equal(frames, plain_frames)}")
        if not np.array_equal(frames, plain_frames) \
                or roll_launches != (2 * len(rcams), 0):
            raise AssertionError("the camera-sharded rollout differs")

        # the world-1 DP step over the two cameras (b) shards
        cam2 = Camera.look_at([-3.0, 2.5, 1.0], [0, 0, 0], [0, 0, 1], 60.0,
                              res, res, device=dev)
        dp_g = make_dp_train_step(cfg_train, mesh, impl="tiled",
                                  return_grads=True)
        _, dp1 = dp_g(state0, stack_cameras([cam, cam2]),
                      torch.zeros((2, res, res, 3), device=dev))
        # the ring's lossless single-tier capacity: a chunk sizes its own
        # spill tier, so the two-tier split is off; K holds the whole
        # set's fullest tile
        with torch.no_grad():
            *_, st = bin_and_gather_packed(project(g, cam, cfg), res, res,
                                           cfg)
            k_lossless = -(-int(st.max_tile_count) // 128) * 128
            cfg_ring = dataclasses.replace(cfg, tile_capacity=k_lossless,
                                           two_tier_split=0)
            geom_w, feat_w, counts_w, st_w = bin_and_gather_packed(
                project(g, cam, cfg_ring), res, res, cfg_ring)
        if int(st_w.truncated_gaussians) or int(st_w.overflowed_tiles):
            raise AssertionError("the whole set's binning at K="
                                 f"{k_lossless} is not lossless")
    finally:
        dist.destroy_process_group()

    # the rollout CLI with --shard-cameras and no launcher (one rank: it
    # makes its own NCCL group) writes the unsharded CLI's PNGs
    scene = os.path.join(tmp, "scene.ply")
    save_ply(scene, rg)
    argv = ["--scene", scene, "--urdf", urdf, "--trajectory", traj_path,
            "--cameras", cams_path, "--output"]
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cli_rollout.main(argv + [os.path.join(tmp, "shard"),
                                 "--shard-cameras"])
        cli_s = time.perf_counter() - t0
        cli_rollout.main(argv + [os.path.join(tmp, "plain")])
    names = sorted(os.listdir(os.path.join(tmp, "plain")))
    same = names == sorted(os.listdir(os.path.join(tmp, "shard"))) and all(
        np.array_equal(read_png_rgb(os.path.join(tmp, "shard", f)),
                       read_png_rgb(os.path.join(tmp, "plain", f)))
        for f in names)
    log(f"  cli.render_rollout --shard-cameras (no launcher): "
        f"{printed.getvalue().splitlines()[0]}; {len(names)} PNGs in "
        f"{cli_s:.2f} s, equal to the unsharded CLI's: {same}")
    if not same or len(names) != 2 * len(rcams):
        raise AssertionError("cli.render_rollout --shard-cameras differs")

    # 12b. two ranks over gloo on the one card
    t_b = time.perf_counter()
    cpu = torch.device("cpu")
    state_cpu = fresh(g.to(cpu))
    half = g.capacity // 2
    g_cpu = g.to(cpu)
    g_shards = [g_cpu.replace(**{f.name: getattr(g_cpu, f.name)[
        r * half:(r + 1) * half] for f in dataclasses.fields(g_cpu)})
        for r in range(2)]
    cfg_train_ring = dataclasses.replace(cfg_train, render=cfg_ring)
    shards = [shard_train_state(state_cpu, 2, r) for r in range(2)]
    cases = [
        ("dp", dist_run.dp_step, dict(
            mesh_shape=(2, 1), cfg=cfg_train, impl="tiled", state=state_cpu,
            cams=[cam.to(cpu), cam2.to(cpu)],
            targets=np.zeros((2, res, res, 3), np.float32))),
        ("blocks", dist_run.ring, dict(
            mesh_shape=(2, 1), cfg=cfg_ring, shards=g_shards,
            camera=cam.to(cpu), background=np.zeros(3, np.float32)))]
    for gather in ("all_gather", "ring"):
        cases.append((gather, dist_run.gs_step, dict(
            mesh_shape=(2, 1), cfg=cfg_train_ring, impl="tiled",
            gather=gather, shards=shards, camera=cam.to(cpu),
            target=np.zeros((res, res, 3), np.float32))))
    cases += [
        ("rollout", dist_run.rollout, dict(
            mesh_shape=(2, 1), background=rg.to(cpu), urdfs=[urdf],
            trajectory=traj, cameras=[c.to(cpu) for c in rcams], cfg=rcfg,
            mesh_cfg=ROLLOUT_MESH, base_poses=poses)),
        ("comm", dist_run.comm_totals, {})]
    try:
        ranks = dist_run.run_ranks(dist_run.run_cases, 2, backend="gloo",
                                   device="cuda", args=(cases,))
    finally:
        tmp_dir.cleanup()
    b_s = time.perf_counter() - t_b
    for r, rk in enumerate(ranks):
        d = rk["dp"]
        loss_err = abs(float(d["loss"]) - float(dp1["loss"])) \
            / abs(float(dp1["loss"]))
        g_err, g_worst = grad_err(d["grads"], dp1["grads"])
        log(f"  (b) rank {r}, gloo on {torch.cuda.get_device_name(0)}: DP "
            f"over 2 cameras (one a rank) against world 1: loss "
            f"{float(d['loss']):.8f} (rel {loss_err:.3e}), gradients "
            f"max|d| / max {g_err:.3e} (worst {g_worst}), launches "
            f"{tuple(d['launches'])}")
        if loss_err > 1e-5 or g_err > 2e-6 \
                or tuple(d["launches"]) != (1, 1):
            raise AssertionError("the 2-rank DP step differs from world 1")
        a, b = rk["all_gather"], rk["ring"]
        loss_err = abs(float(b["loss"]) - float(a["loss"])) \
            / abs(float(a["loss"]))
        g_err, g_worst = grad_err(b["grads"], a["grads"])
        log(f"  rank {r}: ring step against all_gather step (2 shards of "
            f"{half}, K={k_lossless}): loss {float(b['loss']):.8f} (rel "
            f"{loss_err:.3e}), gradients max|d| / max {g_err:.3e} (worst "
            f"{g_worst}); "
            f"launches {tuple(b['launches'])} / {tuple(a['launches'])}; "
            f"comm ring {b['comm_calls']}, all_gather {a['comm_calls']}")
        if loss_err > 1e-5 or g_err > 2e-6 \
                or tuple(b["launches"]) != (1, 1) \
                or tuple(a["launches"]) != (1, 1) \
                or b["comm_calls"].get("all_gather") != 1:
            raise AssertionError("the ring step differs from all_gather")
        if not np.array_equal(rk["rollout"]["frames"], frames):
            raise AssertionError(f"rank {r}'s camera-sharded rollout differs "
                                 "from world 1's")
        for key in ("dp", "blocks", "all_gather", "ring", "rollout"):
            sharded_launches[0] += rk[key]["launches"][0]
            sharded_launches[1] += rk[key]["launches"][1]
    log(f"  camera-sharded rollout, 2 cameras a rank: bit-equal to (a) on "
        f"both ranks; staged through the host by comm.py: "
        + ", ".join(f"rank {r} {rk['comm']['staged_bytes']} B"
                    for r, rk in enumerate(ranks))
        + f"; (b) {b_s:.1f} s. Both ranks share one card over gloo: this "
        f"measures no scaling")

    # the ring's merged blocks: counts against the whole set, then both
    # kernels against their plain versions on them
    rb = ranks[0]["blocks"]
    geom_r, feat_r = (torch.from_numpy(rb[k]).to(dev) for k in ("geom",
                                                                "feat"))
    counts_r = torch.from_numpy(rb["counts"]).to(dev)
    stats = {k: int(v) for k, v in rb["stats"].items()}
    equal = bool(torch.equal(counts_r, counts_w))
    kmask = (torch.arange(k_lossless, device=dev)[None, None, :]
             < counts_w[:, None, None])
    blk_err = max(float(torch.where(kmask, a - b, 0.0).abs().max())
                  for a, b in ((geom_r, geom_w), (feat_r, feat_w)))
    log(f"  ring merged blocks (T={geom_r.shape[0]}, K={k_lossless}): counts "
        f"bit-equal to the whole set's: {equal}; truncated "
        f"{stats['truncated_gaussians']}, overflowed tiles "
        f"{stats['overflowed_tiles']}; valid slots max|d| {blk_err:.3e}")
    if not equal or stats["truncated_gaussians"] \
            or stats["overflowed_tiles"] or blk_err > 1e-5:
        raise AssertionError("the ring's merged blocks differ from the "
                             "whole set's binning")
    tiles_x, _ = num_tiles(res, res, cfg.tile_size)
    kw = dict(tiles_x=tiles_x, cfg=cfg_ring, has_dlim=False)
    fwd = composite_fwd(geom_r, feat_r, counts_r, None, **kw)
    torch.cuda.synchronize()
    err_f, _ = compare_fwd(fwd, composite_fwd_plain(geom_r, feat_r, counts_r,
                                                    None, **kw),
                           "fwd on the ring's blocks",
                           (geom_r, counts_r, None, kw))
    gout = torch.randn(fwd[0].shape, generator=torch.Generator()
                       .manual_seed(12)).to(dev)
    bwd = composite_bwd(geom_r, feat_r, counts_r, None, gout, *fwd[1:], **kw)
    torch.cuda.synchronize()
    err_b = compare_bwd(bwd, composite_bwd_plain(
        geom_r, feat_r, counts_r, None, gout, *fwd[1:], **kw),
        "bwd on the ring's blocks")
    log(f"  sharded launches: composite_fwd {sharded_launches[0]}, "
        f"composite_bwd {sharded_launches[1]}; phase 12 "
        f"{time.perf_counter() - t12:.1f} s")
    return {"launches": sharded_launches, "fwd_max_abs_err": err_f,
            "bwd_max_abs_err": err_b, "steps": out}


def rollout(dev, smi: str) -> dict:
    """Phase 7: the rollout path at full width (the rollout workload of
    tools/workloads.py: 200k splats, the 24,576-triangle object, 8 steps x
    4 cameras at 640x480). The CLI writes its 32 PNGs; render_rollout in
    process launches the forward kernel once per (step, camera); every
    check raises. Returns the forward kernel's numbers at this shape."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from robosimgs_tpu_torch.cli import render_rollout as cli_rollout
    from robosimgs_tpu_torch.core.types import Gaussians
    from robosimgs_tpu_torch.render.binning import bin_and_gather_packed
    from robosimgs_tpu_torch.render.compose import (merge_mesh_layers,
                                                    render_composite)
    from robosimgs_tpu_torch.render.gathered import tile_image
    from robosimgs_tpu_torch.render.kernels import (composite_bwd,
                                                    composite_fwd,
                                                    composite_fwd_plain)
    from robosimgs_tpu_torch.render.mesh_raster import rasterize_mesh
    from robosimgs_tpu_torch.render.project import project
    from robosimgs_tpu_torch.render.tiles import num_tiles
    from robosimgs_tpu_torch.scenegen.rollout import (ArticulatedObject,
                                                      render_rollout)
    from robosimgs_tpu_torch.scenegen.trajectory import load_trajectory
    from robosimgs_tpu_torch.tools.workloads import (ROLLOUT_BASE,
                                                     ROLLOUT_MESH,
                                                     ROLLOUT_STEPS,
                                                     grid_box_mesh,
                                                     rollout_scene, time_ms,
                                                     write_rollout_inputs,
                                                     write_rollout_object)
    from robosimgs_tpu_torch.train.io_ply import save_ply
    from robosimgs_tpu_torch.utils.imresize import read_png_rgb
    from robosimgs_tpu_torch.utils.profiling import device_rows

    t7 = time.perf_counter()
    g, cams, cfg = rollout_scene(dev)
    n_cam, W, H = len(cams), cams[0].width, cams[0].height
    tx, ty = num_tiles(W, H, cfg.tile_size)
    log(f"[7 rollout] {g.capacity} splats, {n_cam} cameras {W}x{H}; spill "
        f"tier fitted to this draw: two_tier_spill_frac "
        f"{cfg.two_tier_spill_frac:.6f} (bench.py's draw: 0.44864)")
    with torch.no_grad():
        for i, c in enumerate(cams):
            *_, st = bin_and_gather_packed(project(g, c, cfg), W, H, cfg)
            # K=512 overflows by design (saturated tiles keep their
            # closest 512, gated below against K=8192); M must not truncate
            log(f"  cam {i}: splats truncated "
                f"{int(st.truncated_gaussians)}, overflowed tiles "
                f"{int(st.overflowed_tiles)} of {tx * ty}, max_tile_count "
                f"{int(st.max_tile_count)}, pairs {int(st.total_pairs)}")
            if int(st.truncated_gaussians):
                raise AssertionError(f"rollout cam {i} truncates splats")

    with tempfile.TemporaryDirectory() as tmp:
        urdf = write_rollout_object(tmp)
        obj = ArticulatedObject.from_urdf(urdf)
        traj_path, cams_path = write_rollout_inputs(tmp, obj.model)
        traj, poses = load_trajectory(traj_path, [obj.model])
        scene = os.path.join(tmp, "scene.ply")
        save_ply(scene, g)
        out_dir = os.path.join(tmp, "frames")
        composite_fwd.launches = 0
        t_cli = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            cli_rollout.main(["--scene", scene, "--urdf", urdf,
                              "--trajectory", traj_path, "--cameras",
                              cams_path, "--steps", str(ROLLOUT_STEPS),
                              "--n-cameras", str(n_cam), "--width", str(W),
                              "--height", str(H), "--autotune", "--output",
                              out_dir])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t_cli
        log(printed.getvalue().rstrip())
        cli_mesh_k = int(printed.getvalue().split("mesh_K=")[1].split()[0])
        names = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
        if len(names) != ROLLOUT_STEPS * n_cam:
            raise AssertionError(f"the rollout CLI wrote {len(names)} PNGs")
        cli_frames = np.stack([np.stack([read_png_rgb(os.path.join(
            out_dir, f"frame_{t:04d}_cam{c}.png")) for c in range(n_cam)])
            for t in range(ROLLOUT_STEPS)])
    log(f"  cli.render_rollout --autotune: {len(names)} PNGs {W}x{H} in "
        f"{cli_s:.1f} s, launches {composite_fwd.launches} (autotune's "
        f"gate renders included), mesh tile capacity {cli_mesh_k}")

    # the main path in process: one forward launch per (step, camera)
    composite_fwd.launches = composite_bwd.launches = 0
    t0 = time.perf_counter()
    frames = render_rollout(g, [obj], traj, cams, cfg=cfg, mesh_cfg=ROLLOUT_MESH,
                            base_poses=poses)
    torch.cuda.synchronize()
    roll_s = time.perf_counter() - t0
    launches = (composite_fwd.launches, composite_bwd.launches)
    log(f"  render_rollout {ROLLOUT_STEPS} steps x {n_cam} cameras: "
        f"{roll_s:.2f} s, launches fwd {launches[0]} bwd {launches[1]}")
    if launches != (ROLLOUT_STEPS * n_cam, 0):
        raise AssertionError(f"render_rollout launched {launches}")
    if frames.shape != (ROLLOUT_STEPS, n_cam, H, W, 3) \
            or not np.isfinite(frames).all():
        raise AssertionError(f"rollout frames {frames.shape}, not finite")
    moved = float(np.abs(frames[ROLLOUT_STEPS // 2] - frames[0]).max())
    q = np.clip(np.round(frames * 255.0), 0, 255)
    cli_db = min(psnr(torch.from_numpy(cli_frames[:, c] / 255.0),
                      torch.from_numpy(q[:, c] / 255.0)) for c in range(n_cam))
    log(f"  the lid moves: max change {moved:.3f}; CLI PNGs (autotuned "
        f"capacities) against the in-process frames (mesh capacity "
        f"{ROLLOUT_MESH.tile_capacity}): {cli_db:.1f} dB")
    if moved < 1e-2 or cli_db < 60.0:
        raise AssertionError("rollout frames do not move or the CLI's differ")

    # every (step, camera, link): no truncated triangle, no overflowed tile
    # at the workload's mesh capacity (the CLI keeps the default 512)
    worst, cover, past_default = 0, [], 0
    with torch.no_grad():
        for t in range(ROLLOUT_STEPS):
            meshes = obj.posed_meshes(traj[t], base_pose=poses[t, 0],
                                      device=dev)
            for i, c in enumerate(cams):
                masks = []
                for v, f, col in meshes:
                    o = rasterize_mesh(v, f, c, vertex_colors=col,
                                       cfg=ROLLOUT_MESH)
                    s = o["stats"]
                    if int(s.truncated_gaussians) or int(s.overflowed_tiles):
                        raise AssertionError(
                            f"step {t} cam {i}: mesh truncates "
                            f"{int(s.truncated_gaussians)} triangles, "
                            f"overflows {int(s.overflowed_tiles)} tiles")
                    worst = max(worst, int(s.max_tile_count))
                    past_default += int(s.max_tile_count) > 512
                    masks.append(o["mask"])
                cover.append(float((masks[0] | masks[1]).float().mean()))
    log(f"  mesh: {len(meshes)} links, {sum(int(m[1].shape[0]) for m in meshes)}"
        f" triangles, 0 truncated and 0 overflowed at K="
        f"{ROLLOUT_MESH.tile_capacity} over {ROLLOUT_STEPS} steps x {n_cam} "
        f"cameras, max_tile_count {worst} ({past_default} of "
        f"{len(cover) * len(meshes)} link renders past the default K=512); "
        f"object covers {min(cover):.3f}-{max(cover):.3f} of a view")
    if min(cover) < 0.01:
        raise AssertionError("the object occludes nothing in some view")
    if worst > cli_mesh_k:
        raise AssertionError(f"the CLI's mesh capacity {cli_mesh_k} "
                             f"overflows: a tile wants {worst}")

    # against the lossless render (K=8192) at step 0
    cfg_ll = type(cfg)(**{**cfg.__dict__, "tile_capacity": 8192})
    full = render_rollout(g, [obj], traj[:1], cams, cfg=cfg_ll,
                          mesh_cfg=ROLLOUT_MESH, base_poses=poses[:1])
    dbs = [psnr(torch.from_numpy(frames[0, c]), torch.from_numpy(full[0, c]))
           for c in range(n_cam)]
    log("  K=512 against K=8192 at step 0: "
        + " ".join(f"{d:.1f}" for d in dbs) + " dB")
    if min(dbs) < 60.0:
        raise AssertionError("the rollout config is below 60 dB")

    # the kernel against its plain version with camera 0's mesh depth limit
    def mesh_layers(cam, meshes):
        return merge_mesh_layers([
            {k: o[k] for k in ("rgb", "depth", "mask", "face_id")}
            for o in (rasterize_mesh(v, f, cam, vertex_colors=col,
                                     cfg=ROLLOUT_MESH)
                      for v, f, col in meshes)])

    with torch.no_grad():
        meshes0 = obj.posed_meshes(traj[0], base_pose=poses[0, 0], device=dev)
        m0 = mesh_layers(cams[0], meshes0)
        proj0 = project(g, cams[0], cfg)
        geom, feat, counts, _ = bin_and_gather_packed(proj0, W, H, cfg)
        dlim = tile_image(m0["depth"], tx, ty, cfg.tile_size,
                          pad_value=float("inf"))[..., None].contiguous()
        kw = dict(tiles_x=tx, cfg=cfg, has_dlim=True)
        got = composite_fwd(geom, feat, counts, dlim, **kw)
        torch.cuda.synchronize()
        err, _ = compare_fwd(got, composite_fwd_plain(geom, feat, counts, dlim,
                                                      **kw),
                             f"rollout cam 0 {W}x{H} mesh depth limit",
                             (geom, counts, dlim, kw))
    log(f"  cam 0: T={geom.shape[0]} K={geom.shape[2]}, depth limit finite on"
        f" {float(torch.isfinite(m0['depth']).float().mean()):.3f} of the "
        f"pixels, blocks per tile max {int(got[2].max())} mean "
        f"{float(got[2].float().mean()):.2f}")

    # the card against the CPU path (plain versions) on a small scene
    small = Gaussians.random(torch.Generator().manual_seed(3), 1500,
                             sh_degree=2, extent=1.5, device=dev)
    cam_s = cams[0].resized(64, 48)
    box = grid_box_mesh((0.25, 0.25, 0.1), 2, (0.8, 0.6, 0.4), seed=0)
    mesh_np = (box.vertices + np.float32(ROLLOUT_BASE), box.faces,
               box.vertex_colors)
    cfg_s = type(cfg)(tile_capacity=512)
    outs = {}
    for d in ("cpu", "cuda"):
        m = [tuple(torch.from_numpy(x).to(d) for x in mesh_np)]
        with torch.no_grad():
            outs[d] = (render_composite(small.to(d), cam_s.to(d), m, cfg_s,
                                        impl="tiled"),
                       rasterize_mesh(*m[0][:2], cam_s.to(d),
                                      vertex_colors=m[0][2]))
    card, cpu = outs["cuda"], outs["cpu"]
    errs = {k: (card[0][k].cpu() - cpu[0][k]).abs()
            for k in ("rgb", "alpha", "splat_depth")}
    mask_off = int((card[1]["mask"].cpu() != cpu[1]["mask"]).sum())
    both = card[1]["mask"].cpu() & cpu[1]["mask"]
    dep_err = float((card[1]["depth"].cpu() - cpu[1]["depth"])[both].abs().max())
    log(f"  card vs CPU, 64x48 with a box: render_composite max|err| "
        + " ".join(f"{k} {float(e.max()):.2e}" for k, e in errs.items())
        + f"; rasterize_mesh mask off on {mask_off} px, depth max|err| "
        f"{dep_err:.2e}")
    if any(float(e.max()) > 2e-3 or float((e > 1e-4).float().mean()) > 1e-3
           for e in errs.values()) or mask_off > 3 or dep_err > 1e-5 \
            or not bool(both.any()):
        raise AssertionError("the rollout path on the card disagrees with "
                             "the CPU path")

    # times: the 4-camera frame, its stages, the kernel at this shape
    with torch.no_grad():
        def frame():
            meshes = obj.posed_meshes(traj[0], base_pose=poses[0, 0],
                                      device=dev)
            return [render_composite(g, c, meshes, cfg, ROLLOUT_MESH)["rgb"]
                    for c in cams]

        frame_ms = time_ms(frame, reps=10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 10
        n_prof = 3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_prof):
                frame()
            torch.cuda.synchronize()
        stages = {
            "rasterize_mesh x2 + merge": time_ms(
                lambda: mesh_layers(cams[0], meshes0), reps=10),
            "project": time_ms(lambda: project(g, cams[0], cfg), reps=20),
            "bin_and_gather_packed": time_ms(
                lambda: bin_and_gather_packed(proj0, W, H, cfg), reps=10),
            "composite_fwd": time_ms(
                lambda: composite_fwd(geom, feat, counts, dlim, **kw), reps=200),
        }
        plain_ms = time_ms(lambda: composite_fwd_plain(geom, feat, counts,
                                                       dlim, **kw), reps=5)
        bound_ms, bound_by, detail, _ = fwd_bound(geom, counts, got[2], dlim,
                                                  tx, cfg)
    events = device_rows(prof)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / n_prof
    n_kern = sum(e.count for e in events) // n_prof
    kernel_ms = stages["composite_fwd"]
    log(f"[7 times] {smi}: rollout frame ({n_cam} x {W}x{H}, {len(meshes0)} "
        f"mesh links) {frame_ms:.4f} ms (CUDA events), host wall "
        f"{wall_ms:.4f} ms, device busy {busy_ms:.4f} ms (profiler, {n_kern} "
        f"kernels/frame), idle share {1 - busy_ms / wall_ms:.3f}")
    log("  stages per camera (ms, CUDA events): "
        + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
        + f"; x{n_cam} = {n_cam * sum(stages.values()):.4f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3 / n_prof:8.4f} ms "
            f"x{e.count // n_prof:<4d} {e.key[:90]}")
    log(f"  composite_fwd at the rollout shape {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, {launches[0] // ROLLOUT_STEPS} launches per "
        f"frame; bound {bound_ms:.6f} ms ({detail}), share "
        f"{bound_ms / kernel_ms:.4f}; library call: none; phase "
        f"{time.perf_counter() - t7:.1f} s")
    return {"launches": launches[0], "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def device_busy(run, n: int):
    """(device busy ms per call, kernels per call) of run() over n calls,
    from the profiler's device-side events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from robosimgs_tpu_torch.utils.profiling import device_rows
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    events = device_rows(prof)
    return (sum(e.self_device_time_total for e in events) / 1e3 / n,
            sum(e.count for e in events) / n)


def wall_ms(run, n: int) -> float:
    """Host wall ms per call of run() over n calls, ending in a sync."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def policy(dev, smi: str) -> dict:
    """Phase 8: the policy stage at DiffusionPolicyConfig's defaults with
    one joint (the rollout object's hinge). Renders a dataset with
    render_rollout, trains PolicyTrainer, holds the card against the CPU
    path, times sampling, runs the closed loop in the renderer (the
    forward kernel once per observation) and the CLI chain; every check
    raises. Returns the forward kernel's numbers at the closed-loop
    shape."""
    import numpy as np
    import torch

    from robosimgs_tpu_torch.cli import render_rollout as cli_rollout
    from robosimgs_tpu_torch.cli import train_policy as cli_policy
    from robosimgs_tpu_torch.core.camera import Camera
    from robosimgs_tpu_torch.policy.diffusion import (DiffusionPolicy,
                                                      DiffusionPolicyConfig,
                                                      NoiseSchedule)
    from robosimgs_tpu_torch.policy.inference import ActionChunker
    from robosimgs_tpu_torch.policy.rollout_eval import run_closed_loop
    from robosimgs_tpu_torch.policy.trainer import (PolicyTrainConfig,
                                                    PolicyTrainer,
                                                    RolloutDataset,
                                                    load_policy,
                                                    policy_loss,
                                                    predict_actions)
    from robosimgs_tpu_torch.render.autotune import (mesh_demand,
                                                     mesh_tile_capacity,
                                                     recommend_capacities)
    from robosimgs_tpu_torch.render.binning import bin_and_gather_packed
    from robosimgs_tpu_torch.render.compose import merge_mesh_layers
    from robosimgs_tpu_torch.render.gathered import tile_image
    from robosimgs_tpu_torch.render.kernels import (composite_fwd,
                                                    composite_fwd_plain)
    from robosimgs_tpu_torch.render.mesh_raster import (MeshRasterConfig,
                                                        rasterize_mesh)
    from robosimgs_tpu_torch.render.project import project
    from robosimgs_tpu_torch.render.tiles import num_tiles
    from robosimgs_tpu_torch.scenegen.rollout import (ArticulatedObject,
                                                      open_close_trajectory,
                                                      render_rollout,
                                                      rollout_meshes)
    from robosimgs_tpu_torch.scenegen.trajectory import load_trajectory
    from robosimgs_tpu_torch.tools.workloads import (ROLLOUT_BASE,
                                                     ROLLOUT_CAMERAS,
                                                     rollout_scene, time_ms,
                                                     write_rollout_inputs,
                                                     write_rollout_object)
    from robosimgs_tpu_torch.train.io_ply import save_ply

    t8 = time.perf_counter()
    g, _, _ = rollout_scene(dev)
    spec = ROLLOUT_CAMERAS[0]
    cam = Camera.look_at(spec["eye"], spec["target"], spec["up"], spec["fov"],
                         96, 96, device=dev)
    base = np.eye(4, dtype=np.float32)
    base[:3, 3] = ROLLOUT_BASE
    with tempfile.TemporaryDirectory() as tmp:
        obj = ArticulatedObject.from_urdf(write_rollout_object(tmp),
                                          base_pose=base)

    # 1. data: open-close sweeps of the hinge at four speeds
    lengths = (24, 32, 40, 48)
    trajs = [open_close_trajectory(obj.model, n) for n in lengths]
    cfg = recommend_capacities(g, [cam], gate_db=60.0)
    demand = mesh_demand(rollout_meshes([obj], np.concatenate(trajs),
                                        device=dev), [cam])
    mesh_cfg = MeshRasterConfig(
        tile_capacity=mesh_tile_capacity(demand["max_tile_count"]))
    t0 = time.perf_counter()
    frames = [render_rollout(g, [obj], tr, [cam], cfg=cfg, mesh_cfg=mesh_cfg)
              for tr in trajs]
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    images = np.concatenate([f[:, 0] for f in frames])
    states = np.concatenate(trajs)
    actions = np.concatenate([np.concatenate([t[1:], t[-1:]]) for t in trajs])
    ds = RolloutDataset(images=images, states=states, actions=actions,
                        episode_ends=list(np.cumsum(lengths)))
    n_frames = len(images)
    log(f"[8 policy] {smi}: dataset {len(lengths)} episodes, {n_frames} "
        f"frames 96x96 rendered in {render_s:.2f} s "
        f"({render_s / n_frames * 1e3:.2f} ms/frame; K={cfg.tile_capacity}, "
        f"mesh tile capacity {mesh_cfg.tile_capacity} for up to "
        f"{demand['max_tile_count']} triangles a tile, truncated triangles "
        f"{demand['truncated_triangles']}); images std {images.std():.3f}")
    if not np.isfinite(images).all() or images.std() < 1e-2:
        raise AssertionError("the policy dataset is blank or not finite")

    # 2. training at batch 64
    pc = DiffusionPolicyConfig(action_dim=1, state_dim=1)
    n_train = 300
    tcfg = PolicyTrainConfig(policy=pc, lr=3e-4, warmup_steps=30,
                             total_steps=n_train, batch_size=64)
    trainer = PolicyTrainer(tcfg, ds, seed=0)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    trainer.run(20, log_every=10, progress=False)       # warmup
    t0 = time.perf_counter()
    trainer.run(n_train - 20, log_every=10, progress=False)
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3 / (n_train - 20)
    losses = [h["loss"] for h in trainer.history]
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    log(f"  PolicyTrainer {n_params} parameters, {n_train} steps at batch "
        f"{tcfg.batch_size}: PolicyTrainer.run {run_ms:.4f} ms/step host wall"
        f" (host batch gather, copy, step and a loss sync every 10 steps), "
        f"{tcfg.batch_size / run_ms * 1e3:.1f} samples/s; loss first 3 logs "
        f"{first:.4f}, last 3 {last:.4f}")
    if not all(np.isfinite(losses)) or not last < 0.7 * first:
        raise AssertionError(f"the policy loss did not fall: {losses}")

    # the step on one device batch, and its layers (a second trainer, so
    # that the timing does not train the evaluated one)
    timer = PolicyTrainer(tcfg, ds, seed=1)
    batch = timer.sample_batch()
    nbytes = sum(x.nbytes for x in batch)
    xb = timer.to_device(batch)
    step_ms = time_ms(lambda: timer.train_step(*xb), reps=50)
    step_wall = wall_ms(lambda: timer.train_step(*xb), 50)
    busy, n_kern = device_busy(lambda: timer.train_step(*xb), 5)
    copy_ms = time_ms(lambda: timer.to_device(batch), reps=20)
    gather_ms = wall_ms(timer.sample_batch, 20)
    m = timer.model
    bs = tcfg.batch_size
    t_d = torch.randint(0, 100, (bs,), device=dev)
    noise = torch.randn(xb[2].shape, device=dev)
    with torch.no_grad():
        emb = m.encode(xb[0], xb[1])
        noisy = timer.schedule.add_noise(xb[2], noise, t_d)
        enc_ms = time_ms(lambda: m.encode(xb[0], xb[1]), reps=50)
        den_ms = time_ms(lambda: m.denoise(noisy, t_d, emb), reps=50)

    def fwd_bwd():
        timer.optimizer.zero_grad(set_to_none=True)
        policy_loss(m, *xb, t_d, noise, timer.schedule).backward()

    fb_ms = time_ms(fwd_bwd, reps=50)
    upd_ms = time_ms(timer.apply_update, reps=50)
    log(f"  train step on a device batch: {step_ms:.4f} ms (CUDA events), "
        f"host wall {step_wall:.4f} ms, device busy {busy:.4f} ms "
        f"(profiler, {n_kern:.0f} kernels/step), idle share "
        f"{1 - busy / step_wall:.3f}; {bs / step_wall * 1e3:.1f} samples/s")
    log(f"  layers (ms, CUDA events): encoder fwd {enc_ms:.4f}, denoiser fwd "
        f"{den_ms:.4f}, loss fwd+bwd {fb_ms:.4f}, AdamW + EMA {upd_ms:.4f}; "
        f"host batch gather {gather_ms:.4f} ms (host wall), host-to-device "
        f"copy of {nbytes} B {copy_ms:.4f} ms "
        f"({nbytes / copy_ms / 1e6:.2f} GB/s)")

    # 3. the card against the CPU path, both encoder heads
    gen = torch.Generator().manual_seed(0)
    imgs = torch.rand((8, 2, 96, 96, 3), generator=gen)
    sts = torch.randn((8, 2, 1), generator=gen)
    acts = torch.rand((8, 16, 1), generator=gen) * 2 - 1
    tt = torch.randint(0, 100, (8,), generator=gen)
    nz = torch.randn((8, 16, 1), generator=gen)
    for ss in (False, True):
        pcs = DiffusionPolicyConfig(action_dim=1, state_dim=1,
                                    spatial_softmax=ss)
        ref = DiffusionPolicy(pcs, torch.Generator().manual_seed(2))
        out, grads = {}, {}
        for d in ("cpu", "cuda"):
            md = DiffusionPolicy(pcs).to(d)
            md.load_state_dict(ref.state_dict())
            args = [x.to(d) for x in (imgs, sts, acts, tt, nz)]
            with torch.no_grad():
                out[d] = md(args[0], args[1], args[2], args[3]).cpu()
            policy_loss(md, *args, NoiseSchedule.make(pcs, d)).backward()
            grads[d] = {k: p.grad.cpu() for k, p in md.named_parameters()}
        f_err = float((out["cuda"] - out["cpu"]).abs().max()) \
            / float(out["cpu"].abs().max())
        g_err = max(float((grads["cuda"][k] - w).abs().max())
                    / float(w.abs().max()) for k, w in grads["cpu"].items())
        log(f"  card vs CPU, {'spatial softmax' if ss else 'average pool'} "
            f"head: forward max|err| {f_err:.3e} of its largest value, "
            f"gradients {g_err:.3e} of each tensor's largest (worst)")
        if f_err > 1e-4 or g_err > 1e-3:
            raise AssertionError("the policy on the card disagrees with "
                                 "the CPU path")

    # 4. sampling latency at B = 1
    obs_i = ds.images[None, :2]
    obs_s = ds.states[None, :2]
    lat = {}
    for n in (16, 100):
        trainer.predict(obs_i, obs_s, n_steps=n)              # warm
        lat[n] = (wall_ms(lambda: trainer.predict(obs_i, obs_s, n_steps=n),
                          10),
                  device_busy(lambda: trainer.predict(obs_i, obs_s,
                                                      n_steps=n), 2))
    log("  predict at B=1: " + "; ".join(
        f"{n} steps {w:.4f} ms/call host wall, device busy {b:.4f} ms, "
        f"{k:.0f} kernels/call" for n, (w, (b, k)) in lat.items()))

    # 5. the closed loop in the renderer: one forward launch per
    # observation (steps + 1) on the one camera
    chunker = ActionChunker(trainer.predict, obs_horizon=2, horizon=16,
                            ensemble=True)
    n_loop = 8
    composite_fwd.launches = 0
    t0 = time.perf_counter()
    res = run_closed_loop(trainer.predict, g, obj, [cam], steps=n_loop,
                          q0=trajs[0][0], cfg=cfg, mesh_cfg=mesh_cfg,
                          chunker=chunker, target_q=trajs[0][len(trajs[0]) // 2])
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3 / n_loop
    launches = composite_fwd.launches
    log(f"  run_closed_loop {n_loop} steps (ensembling ActionChunker, "
        f"{chunker.n_inferences} inferences of 16 steps): {loop_ms:.4f} "
        f"ms/step host wall, composite_fwd launches {launches}, joints "
        + " ".join(f"{q:.3f}" for q in res.joint_history[:, 0])
        + f", final error {res.final_error:.4f}")
    if launches != n_loop + 1:
        raise AssertionError(f"the closed loop launched the forward kernel "
                             f"{launches} times, want {n_loop + 1}")
    if res.frames.shape != (n_loop, 1, 96, 96, 3) \
            or not np.isfinite(res.joint_history).all():
        raise AssertionError("closed-loop result misshapen or not finite")
    # the kernel against its plain version on the last observation
    tx, ty = num_tiles(96, 96, cfg.tile_size)
    with torch.no_grad():
        meshes = obj.posed_meshes(res.joint_history[-1], device=dev)
        m_out = merge_mesh_layers([
            {k: o[k] for k in ("rgb", "depth", "mask", "face_id")}
            for o in (rasterize_mesh(v, f, cam, vertex_colors=c,
                                     cfg=mesh_cfg) for v, f, c in meshes)])
        geom, feat, counts, _ = bin_and_gather_packed(project(g, cam, cfg),
                                                      96, 96, cfg)
        dlim = tile_image(m_out["depth"], tx, ty, cfg.tile_size,
                          pad_value=float("inf"))[..., None].contiguous()
        kw = dict(tiles_x=tx, cfg=cfg, has_dlim=True)
        got = composite_fwd(geom, feat, counts, dlim, **kw)
        torch.cuda.synchronize()
        err, _ = compare_fwd(got, composite_fwd_plain(geom, feat, counts,
                                                      dlim, **kw),
                             "closed-loop observation 96x96 mesh depth limit",
                             (geom, counts, dlim, kw))
        k_ms = time_ms(lambda: composite_fwd(geom, feat, counts, dlim, **kw),
                       reps=200)
        p_ms = time_ms(lambda: composite_fwd_plain(geom, feat, counts, dlim,
                                                   **kw), reps=10)
        bound_ms, bound_by, detail, _ = fwd_bound(geom, counts, got[2], dlim,
                                                  tx, cfg)
    log(f"  composite_fwd at the closed-loop shape (T={geom.shape[0]}, "
        f"K={geom.shape[2]}, mesh depth limit) {k_ms:.4f} ms, plain "
        f"{p_ms:.4f} ms; bound {bound_ms:.6f} ms ({detail}), share "
        f"{bound_ms / k_ms:.4f}; library call: none")

    # 6. the CLI chain: render 640x480 frames, train on them, reload
    with tempfile.TemporaryDirectory() as tmp:
        urdf = write_rollout_object(tmp)
        model = ArticulatedObject.from_urdf(urdf).model
        traj_path, _ = write_rollout_inputs(tmp, model, steps=24)
        cams_path = os.path.join(tmp, "camera.json")
        with open(cams_path, "w") as fh:
            json.dump([spec], fh)
        scene = os.path.join(tmp, "scene.ply")
        save_ply(scene, g)
        frames_dir = os.path.join(tmp, "frames")
        t0 = time.perf_counter()
        cli_rollout.main(["--scene", scene, "--urdf", urdf, "--trajectory",
                          traj_path, "--cameras", cams_path, "--autotune",
                          "--output", frames_dir])
        traj_np = os.path.join(tmp, "traj.npy")
        np.save(traj_np, load_trajectory(traj_path, [model])[0])
        out_dir = os.path.join(tmp, "policy")
        cli_policy.main(["--frames", frames_dir, "--trajectory", traj_np,
                         "--output", out_dir, "--steps", "20"])
        torch.cuda.synchronize()
        chain_s = time.perf_counter() - t0
        with open(os.path.join(out_dir, "train_summary.json")) as fh:
            summary = json.load(fh)
        model_l, norm, cfg_l = load_policy(os.path.join(out_dir, "policy.pt"),
                                           dev)
        obs, _ = cli_policy.load_episode(frames_dir, traj_np, 0, 96)
        pred = predict_actions(model_l, NoiseSchedule.make(cfg_l.policy, dev),
                               norm, obs[None, :2],
                               np.zeros((1, 2, 1), np.float32),
                               torch.Generator(dev).manual_seed(0))
    log(f"  cli.render_rollout 24 x 640x480 -> cli.train_policy 20 steps -> "
        f"policy.pt reloaded: {chain_s:.1f} s, transitions "
        f"{summary['transitions']}, loss {summary['history'][0]['loss']:.4f},"
        f" predicted actions {pred.shape} in [{pred.min():.3f}, "
        f"{pred.max():.3f}]; phase {time.perf_counter() - t8:.1f} s")
    if pred.shape != (1, 16, 1) or not np.isfinite(pred).all() \
            or obs.shape != (24, 96, 96, 3):
        raise AssertionError("the reloaded policy did not predict")
    return {"launches": launches, "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def articulation(dev, smi: str) -> None:
    """Phase 9: the articulation toolchain at full width (the open box of
    tools/workloads.py::open_box_parts: 87,342 vertices, 170,700 triangles,
    the lid opened 60 degrees about the body's back top edge; 800x800
    views, the upstream openbox scan's size and render resolution). No
    compositing kernel runs here and none is counted; every check
    raises."""
    import numpy as np
    import torch

    from robosimgs_tpu_torch.artic.hinge import HingeDetector, _min_dists
    from robosimgs_tpu_torch.artic.mllm import ScriptedMLLM
    from robosimgs_tpu_torch.artic.pipeline import ArticulationPipeline
    from robosimgs_tpu_torch.artic.render_views import (render_canonical_views,
                                                        render_view)
    from robosimgs_tpu_torch.cli import estimate_physics as cli_physics
    from robosimgs_tpu_torch.cli import validate_urdf as cli_validate
    from robosimgs_tpu_torch.cli import visualize_parts as cli_visualize
    from robosimgs_tpu_torch.render.autotune import (mesh_demand,
                                                     mesh_tile_capacity)
    from robosimgs_tpu_torch.render.mesh_raster import (MeshRasterConfig,
                                                        rasterize_mesh)
    from robosimgs_tpu_torch.scenegen.urdf_fk import URDFModel
    from robosimgs_tpu_torch.tools.workloads import open_box_parts, time_ms
    from robosimgs_tpu_torch.utils.bake import bake_vertex_colors_from_views
    from robosimgs_tpu_torch.utils.imresize import read_png_rgb
    from robosimgs_tpu_torch.utils.meshio import concatenate
    from robosimgs_tpu_torch.utils.pointcloud import depth_map_from_points

    t9 = time.perf_counter()
    res = 800
    body, lid = open_box_parts()
    mesh = concatenate([body, lid])
    spacing = 0.5 / 100          # the body's grid spacing along y
    log(f"[9 articulation] open box: lid {len(lid.vertices)} + body "
        f"{len(body.vertices)} vertices, {len(mesh.faces)} triangles; "
        f"{smi}")

    # 9a. hinge: the pairwise distances on the card and on the CPU
    det = HingeDetector(lid, body, device=dev)
    det_cpu = HingeDetector(lid, body, device="cpu")
    hinges, contact, host_ms = {}, {}, {}
    for tag, d in (("card", det), ("cpu", det_cpu)):
        da, db = d.distances()
        thresh = min(da.min(), db.min()) + d.margin
        contact[tag] = (da <= thresh, db <= thresh, da, db)
        t0 = time.perf_counter()
        hinges[tag] = d.detect()
        host_ms[tag] = (time.perf_counter() - t0) * 1e3
    flips = [int((contact["card"][i] != contact["cpu"][i]).sum())
             for i in (0, 1)]
    dist_err = max(float(np.abs(contact["card"][i] - contact["cpu"][i]).max())
                   for i in (2, 3))
    h, hc = hinges["card"], hinges["cpu"]
    va = torch.as_tensor(lid.vertices, device=dev)
    vb = torch.as_tensor(body.vertices, device=dev)
    dist_ms = time_ms(lambda: (_min_dists(va, vb), _min_dists(vb, va)), 3, 1)
    detect_ms = time_ms(det.detect, 3, 1)
    detect_wall = wall_ms(det.detect, 3)
    log(f"  hinge: card contacts {h.contact_count_a} + {h.contact_count_b}, "
        f"CPU {hc.contact_count_a} + {hc.contact_count_b}, contact-set flips "
        f"{flips[0]} + {flips[1]}, distances card vs CPU max {dist_err:.3e} m;"
        f" position {h.position.tolist()} (CPU diff "
        f"{float(np.abs(h.position - hc.position).max()):.3e}), axis "
        f"{h.axis.tolist()} (CPU diff "
        f"{float(np.abs(h.axis - hc.axis).max()):.3e}), confidence "
        f"{h.confidence:.6f}")
    log(f"  hinge times: both distance passes {dist_ms:.4f} ms (CUDA "
        f"events), detect {detect_ms:.4f} ms events / {detect_wall:.4f} ms "
        f"host wall (first call {host_ms['card']:.1f} ms); the same detect "
        f"on the CPU {host_ms['cpu']:.1f} ms")
    for tag, r in hinges.items():
        off = float(np.hypot(r.position[1] - 0.25, r.position[2] - 0.1))
        if not (abs(float(r.axis[0])) > 0.99 and off < spacing):
            raise AssertionError(f"{tag} hinge off the edge: axis "
                                 f"{r.axis.tolist()}, {off:.4f} m from it")

    # 9b. the six canonical views with markers, written as PNGs
    marks = [(np.array([0.0, 0.0, 0.3]), (1.0, 0.0, 0.0)),
             (np.array([0.0, -0.25, 0.0]), (0.0, 1.0, 0.0))]
    with tempfile.TemporaryDirectory() as tmp:
        seg = os.path.join(tmp, "segmentation")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        views = render_canonical_views(mesh, seg, resolution=res,
                                       markers=marks, device=dev)
        torch.cuda.synchronize()
        views_s = time.perf_counter() - t0
        demand = 0
        for name, v in views.items():
            cam = v["camera"]
            ms = time_ms(lambda: render_view(mesh, cam), 2, 1)
            st = v["stats"]
            need = mesh_demand([[(torch.as_tensor(mesh.vertices, device=dev),
                                  torch.as_tensor(mesh.faces, device=dev),
                                  None)]], [cam], MeshRasterConfig(
                tile_capacity=1024))["max_tile_count"]
            demand = max(demand, need)
            log(f"  view {name}: {ms:.2f} ms (CUDA events), covered "
                f"{float(np.isfinite(v['depth']).mean()):.4f}, triangles "
                f"truncated {int(st.truncated_gaussians)}, overflowed tiles "
                f"{int(st.overflowed_tiles)}, max a tile "
                f"{int(st.max_tile_count)} (mesh_demand {need}) at tile "
                f"capacity 1024")
            if not np.isfinite(v["clean"]).all():
                raise AssertionError(f"view {name} is not finite")
        cap = mesh_tile_capacity(demand)
        log(f"  six views with markers: {views_s:.2f} s host wall (both "
            f"renders of each view, PNGs written); largest demand {demand} "
            f"triangles a tile -> capacity {cap}")
        # one view against the CPU path (edge-on faces: the front)
        cam = views["front"]["camera"]
        cpu_img, cpu_depth = render_view(mesh, cam.to("cpu"),
                                         return_depth=True)
        gm = np.isfinite(views["front"]["depth"])
        cm = np.isfinite(cpu_depth)
        view_flips = float((gm != cm).mean())
        both = gm & cm
        view_err = float(np.abs(views["front"]["clean"][both]
                                - cpu_img[both]).max())
        log(f"  front view card vs CPU: mask flips {view_flips:.6f} of "
            f"pixels, rgb max {view_err:.3e} where both cover")
        if view_flips > 1e-3 or view_err > 1e-5:
            raise AssertionError("the front view disagrees with the CPU path")

        # 9c. the pipeline with a scripted MLLM: URDF + metadata
        mllm = ScriptedMLLM(responses=[(
            "Recommend URDF parameters",
            '{"object_type": "box", "base_link": "base", "lower_rad": 0.0, '
            '"upper_rad": 1.57, "effort": 5, "velocity": 2, "friction": 0.5,'
            ' "damping": 0.2, "base_mass_kg": 0.5, "movable_mass_kg": 0.2, '
            '"reasoning": "a box lid"}')])
        t0 = time.perf_counter()
        meta = ArticulationPipeline(lid, body, mllm=mllm, device=dev).generate(
            os.path.join(tmp, "urdf"),
            marked_views=[v["marked"] for v in views.values()])
        pipe_s = time.perf_counter() - t0
        problems = URDFModel.parse(meta["urdf_path"]).validate()
        log(f"  ArticulationPipeline.generate: {pipe_s:.2f} s host wall, "
            f"axis {meta['hinge']['axis']}, limits "
            f"{meta['joint_limits']['lower']}..{meta['joint_limits']['upper']}"
            f", URDF problems {problems}")
        if problems or not meta["mllm_recommendations"]["parameters_used"]:
            raise AssertionError("the generated URDF does not validate")

        # 9d. bake a smooth vertex colour field back from six unshaded
        # renders of it (bilinear sampling blends at silhouettes; the
        # open lid hides part of the body's top and its own underside
        # from every axis view, about a tenth of the vertices)
        cfg = MeshRasterConfig(tile_capacity=cap, max_tiles_per_tri=512)
        cams = [v["camera"] for v in views.values()]
        lo, hi = mesh.bounds
        truth = (0.25 + 0.5 * (mesh.vertices - lo) / (hi - lo)).astype(
            np.float32)
        verts = torch.as_tensor(mesh.vertices, device=dev)
        faces = torch.as_tensor(mesh.faces, device=dev)
        cols = torch.as_tensor(truth, device=dev)
        imgs = []
        with torch.no_grad():
            for cam in cams:
                out = rasterize_mesh(verts, faces, cam, vertex_colors=cols,
                                     cfg=cfg)
                imgs.append(np.where(out["mask"].cpu().numpy()[..., None],
                                     out["rgb"].cpu().numpy(), 0.0)
                            .astype(np.float32))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        colors, seen = bake_vertex_colors_from_views(
            mesh, imgs, cams, tile_capacity=cap)
        bake_s = time.perf_counter() - t0
        err = np.abs(colors[seen] - truth[seen])
        log(f"  bake over six views at capacity {cap}: {bake_s:.2f} s host "
            f"wall, seen {float(seen.mean()):.4f} of vertices, colour error "
            f"median {float(np.median(err)):.5f}, 90th percentile "
            f"{float(np.percentile(err, 90)):.5f}")
        if not (seen.mean() > 0.8 and np.median(err) < 0.02
                and np.percentile(err, 90) < 0.1):
            raise AssertionError("the bake did not recover the colours")

        # 9e. a z-buffer of 1M surface samples at 800x800
        pts_np = mesh.sample_surface(1_000_000, seed=0)
        pts = torch.as_tensor(pts_np, device=dev)
        cam = views["top"]["camera"]
        dmap = depth_map_from_points(pts, cam)
        ms = time_ms(lambda: depth_map_from_points(pts, cam), 10)
        got = dmap.cpu().numpy()
        want = depth_map_from_points(torch.as_tensor(pts_np),
                                     cam.to("cpu")).numpy()
        fin = np.isfinite(got) & np.isfinite(want)
        same = float((np.isfinite(got) == np.isfinite(want)).mean())
        rel = float((np.abs(got[fin] - want[fin])
                     <= 1e-6 * np.abs(want[fin])).mean())
        zbuf = views["top"]["depth"]
        both = fin & np.isfinite(zbuf)
        gap = float(np.median(np.abs(got[both] - zbuf[both]) / zbuf[both]))
        log(f"  depth_map_from_points, 1M points at {res}x{res}: {ms:.4f} ms "
            f"(CUDA events); card vs CPU: empty pixels agree on {same:.6f}, "
            f"depths within 1e-6 relative on {rel:.6f}; against the top "
            f"view's z-buffer median relative gap {gap:.2e}")
        if same < 0.999 or rel < 0.999 or gap > 1e-2:
            raise AssertionError("the point z-buffer disagrees")

        # 9f. the three CLIs on the phase's outputs
        spec = os.path.join(tmp, "spec.json")
        with open(spec, "w") as fh:
            json.dump({"caption": "a box with an open lid", "responses": [
                ["list the 3 most likely materials",
                 '{"1": "rigid: wood", "2": "rigid: metal", '
                 '"3": "deformable: rubber"}']]}, fh)
        phys = os.path.join(tmp, "physics.json")
        vis = os.path.join(tmp, "visualization.png")
        strip = os.path.join(tmp, "strip.png")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli_physics.main([os.path.join(seg, "view_front.png"),
                              "--scripted", spec, "--output", phys])
            cli_visualize.main([tmp, "--out", vis])
            cli_validate.main([meta["urdf_path"], "--render", strip])
        cli_s = time.perf_counter() - t0
        with open(phys) as fh:
            est = json.load(fh)
        shapes = [read_png_rgb(p).shape for p in (vis, strip)]
        log(f"  CLIs: estimate_physics -> {est['method']} {est['material']}, "
            f"visualize_parts {shapes[0]}, validate_urdf --render "
            f"{shapes[1]}: {cli_s:.2f} s; phase "
            f"{time.perf_counter() - t9:.1f} s")
        if est["material"] != "wood" or shapes != [(512, 1536, 3),
                                                   (256, 1280, 3)]:
            raise AssertionError("the articulation CLIs did not run")


@contextlib.contextmanager
def timed_calls(targets):
    """Patch each (owner, attribute) so that its calls add their host
    wall (inclusive of nested timed calls) to walls[attribute]; restore
    on exit."""
    walls, saved = {}, []
    for owner, name in targets:
        fn = getattr(owner, name)

        def wrap(*args, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                walls[_name] = (walls.get(_name, 0.0)
                                + time.perf_counter() - t0)

        saved.append((owner, name, fn))
        setattr(owner, name, wrap)
    try:
        yield walls
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def log_drops(lines) -> None:
    """The renders' dropped-triangle reports, each distinct one once."""
    import collections
    counts = collections.Counter(lines)
    log(f"    renders that dropped triangles: {len(lines)}")
    for ln, n in counts.items():
        log(f"      x{n} {ln}")


def face_hit(mesh, part):
    """Which faces of `mesh` the part holds (a submesh keeps each face's
    three vertices, so the face is found by their coordinates)."""
    import numpy as np

    def keys(m):
        tri = np.ascontiguousarray(m.vertices[m.faces].reshape(-1, 9),
                                   np.float32)
        return [r.tobytes() for r in tri]

    index = {k: i for i, k in enumerate(keys(mesh))}
    hit = np.zeros(len(mesh.faces), bool)
    hit[[index[k] for k in keys(part)]] = True
    return hit


def masknet_flops(model, size: int, batch: int) -> float:
    """Multiply-adds x 2 of MaskUNet's convolutions at (batch, size^2)."""
    def conv(i, res):
        w = model.convs[i].weight
        return 2.0 * w.shape[0] * w.shape[1] * w.shape[2] * w.shape[3] \
            * res * res * batch

    res, i = size, 1
    total = conv(0, res)
    for _ in range(model.levels):
        res //= 2
        total += conv(i, res) + conv(i + 1, res)
        i += 2
    for _ in range(model.levels):
        res *= 2
        total += conv(i, res) + conv(i + 1, res)
        i += 2
    return total + conv(i, res)


def segment(dev, smi: str) -> None:
    """Phase 10: mesh to URDF on the artic workload's open box as one mesh
    (tools/workloads.py::open_box_parts, 170,700 triangles, the lid's
    50,700 first), at the CLI's 800x800 views: cli.articulate with the
    geometric split and with the mask model and three-view fusion, the
    mask model against the CPU, its times, and a short training run on
    the card. No compositing kernel runs here; every check raises."""
    import numpy as np
    import torch

    from robosimgs_tpu_torch.artic import masknet
    from robosimgs_tpu_torch.artic import segmentation as seg
    from robosimgs_tpu_torch.cli import articulate as cli_articulate
    from robosimgs_tpu_torch.cli import validate_urdf as cli_validate
    from robosimgs_tpu_torch.scenegen.urdf_fk import URDFModel
    from robosimgs_tpu_torch.tools.workloads import open_box_parts, time_ms
    from robosimgs_tpu_torch.utils.meshio import (concatenate, load_mesh,
                                                  save_mesh)

    t10 = time.perf_counter()
    body, lid = open_box_parts()
    mesh = concatenate([lid, body])
    truth = np.arange(len(mesh.faces)) < len(lid.faces)
    c = lid.vertices.mean(0)
    seeds = [lid.vertices[np.argmin(((lid.vertices - c) ** 2).sum(1))],
             body.vertices[np.argmin(((body.vertices
                                       - np.array([0.0, -0.25, 0.0])) ** 2)
                                      .sum(1))]]
    points = [str(float(x)) for p in seeds for x in p]
    log(f"[10 segment] open box as one mesh: {len(mesh.vertices)} vertices, "
        f"{len(mesh.faces)} triangles, the lid's {int(truth.sum())} first; "
        f"seeds {np.round(seeds, 4).tolist()}; {smi}")
    stages = [(seg.Segmenter, n) for n in (
        "select_points", "render_views", "choose_best_view", "name_parts",
        "segment_part", "generate_candidates", "fused_labels",
        "split_and_export")] + [
        (seg, "_propagate_nearest"), (seg, "fuse_multiview_labels"),
        (seg, "smooth_face_labels"), (seg, "mask_from_part"),
        (seg, "split_mesh_by_points"), (masknet.MaskNetGenerator,
                                         "generate")]
    captured = {}
    probs = masknet.MaskNetGenerator.probs

    def capture_probs(self, x):
        if x.shape[0] > 1 and "batch" not in captured:
            captured["gen"], captured["batch"] = self, x
        return probs(self, x)

    generate = masknet.MaskNetGenerator.generate

    def capture_generate(self, image, point=None):
        captured.setdefault("image", (image, point))
        return generate(self, image, point)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "openbox.glb")
        save_mesh(path, mesh)
        runs = {}
        for tag, extra in (("geometric", []),
                           ("masknet", ["--mask-backend", "masknet",
                                        "--fusion-views", "3"])):
            out = os.path.join(tmp, tag)
            err = io.StringIO()
            masknet.MaskNetGenerator.probs = capture_probs
            masknet.MaskNetGenerator.generate = capture_generate
            try:
                with timed_calls(stages) as walls, \
                        contextlib.redirect_stdout(io.StringIO()), \
                        contextlib.redirect_stderr(err):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    cli_articulate.main([path, "--output", out, "--points",
                                         *points, "--part-names", "lid",
                                         "box body", "--device", str(dev),
                                         *extra])
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            finally:
                masknet.MaskNetGenerator.probs = probs
                masknet.MaskNetGenerator.generate = generate
            parts = {c: load_mesh(os.path.join(out, "segmentation",
                                               f"part_{c}.glb"))
                     for c in ("RED", "GREEN")}
            if min(len(p.faces) for p in parts.values()) == 0:
                raise AssertionError(f"{tag}: a part is empty")
            hit = face_hit(mesh, parts["RED"])
            with open(os.path.join(out, "urdf", "metadata.json")) as fh:
                meta = json.load(fh)
            urdf = os.path.join(out, "urdf", "articulated_object.urdf")
            problems = URDFModel.parse(urdf).validate()
            if problems:
                raise AssertionError(f"{tag}: URDF problems {problems}")
            axis = np.asarray(meta["hinge"]["axis"])
            pos = np.asarray(meta["hinge"]["original_position"])
            drops = [ln for ln in err.getvalue().splitlines()
                     if "drops triangles" in ln]
            runs[tag] = (out, urdf)
            log(f"  cli.articulate {tag}: {wall:.2f} s host wall; lid "
                f"{len(parts['RED'].faces)} faces (truth {int(truth.sum())})"
                f", face accuracy {float((hit == truth).mean()):.6f} "
                f"({int((hit & ~truth).sum())} body faces in the lid, "
                f"{int((~hit & truth).sum())} lid faces in the body); hinge "
                f"|cos| with x {abs(float(axis[0])):.6f}, "
                f"{float(np.hypot(pos[1] - 0.25, pos[2] - 0.1)) * 1e3:.3f} "
                f"mm from the edge y = 0.25, z = 0.1, confidence "
                f"{meta['hinge']['axis_confidence']:.4f}")
            log("    stage host wall (inclusive): " + ", ".join(
                f"{k} {v:.3f} s" for k, v in walls.items()))
            log_drops(drops)

        # the URDF of the mask path through the validation CLI
        strip = os.path.join(tmp, "strip.png")
        printed, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed), \
                contextlib.redirect_stderr(err):
            cli_validate.main([runs["masknet"][1], "--render", strip,
                               "--device", str(dev)])
        if "kinematic validation: OK" not in printed.getvalue():
            raise AssertionError("cli.validate_urdf did not validate")
        log(f"  cli.validate_urdf --render on the masknet URDF: OK, "
            f"{time.perf_counter() - t0:.2f} s")
        log_drops([ln for ln in err.getvalue().splitlines()
                   if "drops triangles" in ln])

    # the mask model on the chosen view's prompt batch (the grid prompts
    # off the background) and on all grid^2 = 36 prompts: card against CPU
    gen, x = captured["gen"], captured["batch"]
    image, point = captured["image"]
    coords = np.linspace(gen.size * 0.08, gen.size * 0.92, gen.grid)
    x36 = gen._input(gen._resized(image), [(u, v) for v in coords
                                           for u in coords])
    cpu_model = masknet.MaskUNet()
    cpu_model.load_state_dict(gen.model.state_dict())
    for what, batch in (("its prompts off the background", x),
                        ("all grid prompts", x36)):
        with torch.no_grad():
            card = gen.model(batch).cpu()
            host = cpu_model(batch.cpu())
        err = float((card - host).abs().max())
        flips = float(((card > 0) != (host > 0)).float().mean())
        log(f"  MaskUNet on the chosen view, {what} {tuple(batch.shape)}: "
            f"card vs CPU logits max {err:.3e} (|logit| up to "
            f"{float(host.abs().max()):.2f}), thresholded flips {flips:.2e}")
        if err > 1e-4 or flips > 1e-3:
            raise AssertionError("the mask model disagrees card vs CPU")
    x = x36

    def forward():
        with torch.no_grad():
            gen.model(x)

    fwd_ms = time_ms(forward, 10)
    fwd_wall = wall_ms(forward, 10)
    fwd_busy, fwd_kernels = device_busy(forward, 5)
    gen_ms = time_ms(lambda: gen.generate(image, point), 3, 1)
    gen_wall = wall_ms(lambda: gen.generate(image, point), 3)
    gen_busy, gen_kernels = device_busy(lambda: gen.generate(image, point), 2)
    flop = masknet_flops(gen.model, x.shape[1], x.shape[0])
    log(f"  MaskUNet forward at B = {x.shape[0]}: {fwd_ms:.4f} ms (CUDA "
        f"events), {fwd_wall:.4f} ms host wall, busy {fwd_busy:.4f} ms over "
        f"{fwd_kernels:.0f} kernels, idle {1 - fwd_busy / fwd_wall:.3f}; "
        f"{flop / 1e9:.2f} GFLOP ({flop / x.shape[0] / 1e9:.3f} an image), "
        f"{flop / fwd_ms / 1e9:.2f} TFLOP/s")
    log(f"  generate({image.shape[0]}x{image.shape[1]}, point): {gen_ms:.2f}"
        f" ms (CUDA events), {gen_wall:.2f} ms host wall, busy "
        f"{gen_busy:.4f} ms over {gen_kernels:.0f} kernels, idle "
        f"{1 - gen_busy / gen_wall:.3f}")

    # a short training run on the card
    stamps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = masknet.train_masknet(steps=150, size=64, batch=8, n_scenes=24,
                               device=dev,
                               progress=lambda s: stamps.append(
                                   time.perf_counter()))
    train_s = time.perf_counter() - t0
    step_ms = (stamps[-1] - stamps[0]) * 1e3 / (len(stamps) - 1)
    log(f"  train_masknet(150 steps, 64 px, batch 8, 24 scenes) on the card:"
        f" {train_s:.2f} s host wall, {step_ms:.2f} ms a step (host wall, "
        f"the host batch included), loss {tr.losses[0]:.4f} -> "
        f"{tr.losses[-1]:.4f} (ratio {tr.losses[-1] / tr.losses[0]:.3f}), "
        f"hold-out IoU {tr.holdout_iou:.4f}; phase "
        f"{time.perf_counter() - t10:.1f} s")
    if not (tr.losses[-1] < 0.5 * tr.losses[0] and tr.holdout_iou > 0.45):
        raise AssertionError("train_masknet did not learn on the card")


def kernel_counts(prof, n: int) -> dict:
    """{name: launches per step} of the compositing kernels in a profile
    of n steps (the device-side records: inside a CUDA graph's replays
    too, where no wrapper runs). composite_bwd counts both of its
    kernels (composite_bwd_kernel, composite_bwd_split_kernel)."""
    import torch
    counts = {"composite_fwd": 0, "composite_bwd": 0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name in counts:
            if f"{name}_kernel" in e.key or f"{name}_split_kernel" in e.key:
                counts[name] += e.count
    return {k: v / n for k, v in counts.items()}


def nblk_histogram(nblk) -> str:
    """The processed 128-splat blocks per tile: 'value x tiles', by value."""
    import torch
    vals, cnt = torch.unique(nblk.cpu(), return_counts=True)
    return (f"nblk max {int(nblk.max())} mean {float(nblk.float().mean()):.2f}"
            f" sum {int(nblk.sum())}; tiles by nblk "
            + " ".join(f"{int(v)}x{int(c)}" for v, c in zip(vals, cnt)))


def device_ops(prof, n: int, tag: str, top: int = 8) -> dict:
    """Logs a profile of n steps by device operation (kernels, copies,
    sets; self time a step) and returns {"total_ms", "transpose_ms",
    "top"}: transpose_ms is the row gather's transpose, the device time
    of what binning's _GatherRows backward ran."""
    from robosimgs_tpu_torch.utils.profiling import device_rows
    events = device_rows(prof)
    total = sum(e.self_device_time_total for e in events) / 1e3 / n
    transpose = sum(
        e.device_time_total for e in prof.events()
        if e.name == "autograd::engine::evaluate_function: "
                     "_GatherRowsBackward") / 1e3 / n
    log(f"  {tag}: device time {total:.4f} ms a step over "
        f"{sum(e.count for e in events) / n:.0f} operations; the gather's "
        f"transpose (_GatherRows backward) {transpose:.4f} ms, share "
        f"{transpose / max(total, 1e-12):.3f}")
    rows = []
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3 / n
        rows.append((ms, e.count / n, e.key[:90]))
        log(f"    {ms:8.4f} ms x{e.count / n:<6.1f} {e.key[:90]}")
    return dict(total_ms=total, transpose_ms=transpose, top=rows)


def trace_busy(prof):
    """(union ms, summed ms, count) of the device activity (kernels,
    copies, sets) in a profile's trace: the union of their intervals is
    the time the device was busy; a sum above it means they overlapped."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events if e.get("ph") == "X" and e.get("cat")
                   in ("kernel", "gpu_memcpy", "gpu_memset"))
    union = total = 0.0
    end = -math.inf
    for a, b in spans:
        total += b - a
        if b > end:
            union += b - max(a, end)
            end = b
    return union / 1e3, total / 1e3, len(spans)


def leftovers(dev, smi: str) -> dict:
    """Phase 11: training's leftovers and the batched composite at full
    width. (a) the bilateral grid at 1920x1080 and 256x256, card against
    CPU, timed; (b) exposure and the bilateral grid in training on
    cli.train's synthetic scene (tints / a vignette, 300 steps at
    fused_steps 10, on against off), then cli.train --exposure
    --bilateral-grid; (c) fused_steps at the bench workload: the eager
    step against the graph's replay (host wall, CUDA events; wall,
    device busy and kernels a step in one profiled window; capture
    time, memory), and a run with fused_steps 10
    against one without across a densify round, an opacity reset and a
    pool resize; (d) composite_tiled_batch at the rollout workload: one
    forward launch for 4 x 1,200 tiles, the images against four
    composite_tiled calls, the kernel against its plain version, the
    gradient against the per-camera sum, times and bound; (e) on 32x32
    tiles at recommend_capacities' capacities for the bench view both
    kernels against their plain versions, the backward's time and bound,
    Trainer steps there, and a small scene's gradients card against
    CPU; (f) the grid's gate at lr 1e-3, and lr 5e-3 at 600 steps. Returns the numbers of the
    kernels line."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from robosimgs_tpu_torch import Gaussians
    from robosimgs_tpu_torch.cli import render as cli_render
    from robosimgs_tpu_torch.cli import train as cli_train
    from robosimgs_tpu_torch.render.binning import bin_and_gather_packed
    from robosimgs_tpu_torch.render.compose import merge_mesh_layers
    from robosimgs_tpu_torch.render.config import RenderConfig
    from robosimgs_tpu_torch.render.gathered import tile_image
    from robosimgs_tpu_torch.render.kernels import (composite_bwd,
                                                    composite_fwd,
                                                    composite_fwd_plain)
    from robosimgs_tpu_torch.render.mesh_raster import rasterize_mesh
    from robosimgs_tpu_torch.render.project import Projected, project
    from robosimgs_tpu_torch.render.rasterize import rasterize
    from robosimgs_tpu_torch.render.tiled import (composite_tiled,
                                                  composite_tiled_batch,
                                                  stack_projected)
    from robosimgs_tpu_torch.render.tiles import num_tiles
    from robosimgs_tpu_torch.scenegen.rollout import ArticulatedObject
    from robosimgs_tpu_torch.scenegen.trajectory import load_trajectory
    from robosimgs_tpu_torch.tools.workloads import (ROLLOUT_MESH, bench_scene,
                                                     rollout_scene, time_ms,
                                                     write_rollout_inputs,
                                                     write_rollout_object)
    from robosimgs_tpu_torch.train.bilagrid import (apply_bilagrid,
                                                    identity_bilagrid)
    from robosimgs_tpu_torch.train.data import (Frame, camera_extent,
                                                synthetic_scene)
    from robosimgs_tpu_torch.train.trainer import TrainConfig, Trainer
    from robosimgs_tpu_torch.utils.imresize import read_png_rgb
    from robosimgs_tpu_torch.utils.profiling import device_rows

    t11 = time.perf_counter()
    res_out = {}

    # 11a. the bilateral grid: 1920x1080 (32 blocks of 34 rows) and 256x256
    gen = torch.Generator().manual_seed(30)
    grid0 = identity_bilagrid(1, (8, 8, 4), device="cpu")[0] \
        + 0.05 * torch.randn((8, 8, 4, 12), generator=gen)
    for h, w in ((1080, 1920), (256, 256)):
        rgb = torch.rand((h, w, 3), generator=gen)
        wts = torch.randn((h, w, 3), generator=gen)
        got = {}
        for d in ("cpu", "cuda"):
            gr = grid0.to(d, copy=True).requires_grad_(True)
            out = apply_bilagrid(gr, rgb.to(d))
            (out * wts.to(d)).sum().backward()
            got[d] = (out.detach().cpu(), gr.grad.cpu())
        v_err = float((got["cuda"][0] - got["cpu"][0]).abs().max())
        g_err = float((got["cuda"][1] - got["cpu"][1]).abs().max())
        g_max = float(got["cpu"][1].abs().max())
        gr_d = grid0.to(dev, copy=True).requires_grad_(True)
        rgb_d, wts_d = rgb.to(dev), wts.to(dev)

        def fwd_bwd():
            gr_d.grad = None
            (apply_bilagrid(gr_d, rgb_d) * wts_d).sum().backward()

        with torch.no_grad():
            fwd_ms = time_ms(lambda: apply_bilagrid(gr_d, rgb_d), reps=20)
        fb_ms = time_ms(fwd_bwd, reps=20)
        log(f"[11 leftovers] bilateral grid {w}x{h} (8x8x4): card vs CPU "
            f"max|out err| {v_err:.3e}, max|grid grad err| {g_err:.3e} of "
            f"{g_max:.3e}; forward {fwd_ms:.4f} ms, forward+backward "
            f"{fb_ms:.4f} ms (CUDA events; {smi})")
        if v_err > 1e-5 or g_err > 1e-4 * g_max:
            raise AssertionError("the bilateral grid differs on the card")
        res_out[f"bilagrid_{w}x{h}_ms"] = (fwd_ms, fb_ms)

    # 11b. exposure and the grid in training, on cli.train's synthetic
    # scene (20,000 Gaussians, 24 cameras, 256x256) with the JAX tests'
    # tints (cycled over the frames) and vignette, the feature on against
    # off. Training PSNR: the mean over the last visit of every frame
    # (one step's PSNR is one frame's). 300 steps each (12 a frame) at
    # the JAX tests' lr 5e-3; the grid's gate is 11f. No densification
    # (300 steps end before the default densify_from; 11f's 600 too)
    n_syn, size = 20_000, 256
    gt, frames = synthetic_scene(0, n_syn, 24, size, size, sh_degree=2,
                                 device=dev)
    rcfg = RenderConfig(tile_capacity=1024)
    with torch.no_grad():
        clean = [rasterize(gt, f.camera, rcfg, impl="tiled")["rgb"].cpu()
                 .numpy() for f in frames]
    pts = gt.means[gt.alive].cpu().numpy()
    pts = pts + np.random.default_rng(0).normal(
        scale=0.02, size=pts.shape).astype(np.float32)
    extent = camera_extent(frames)
    tints = np.array([[1.3, 0.8, 1.0], [0.8, 1.2, 0.9], [1.0, 1.0, 1.3],
                      [0.9, 0.9, 0.7]], np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    c0 = (size - 1) / 2.0
    vignette = (1.0 - 0.55 * np.clip(((yy - c0) ** 2 + (xx - c0) ** 2)
                                     / c0 ** 2, 0, 1))[:, :, None]
    tinted = [Frame(camera=f.camera, image=np.clip(c * tints[i % 4], 0, 1))
              for i, (f, c) in enumerate(zip(frames, clean))]
    darkened = [Frame(camera=f.camera, image=np.clip(c * vignette, 0, 1))
                for f, c in zip(frames, clean)]
    def colour_runs(feature, fr, n_it, lr, gate, off=None):
        """The feature off and on (at learning rate lr), n_it steps;
        off: the PSNR of an off run these settings would repeat (the
        feature's lr is all they change), not run again."""
        psnrs = {} if off is None else {False: off}
        n_fr = len(fr)
        for on in ((False, True) if off is None else (True,)):
            cfg_f = TrainConfig(
                iterations=n_it, render=rcfg, scene_extent=extent,
                densify_from=10**9, fused_steps=10, log_every=1,
                exposure_lr=lr, bilagrid_shape=(6, 6, 3), bilagrid_lr=lr,
                bilagrid_tv_lambda=1.0, **{feature: on})
            tr = Trainer(cfg_f, Gaussians.from_points(
                pts, sh_degree=3, capacity=24576, device=dev), fr)
            t0 = time.perf_counter()
            tr.run(progress=False)
            torch.cuda.synchronize()
            psnrs[on] = float(np.mean([h["psnr"]
                                       for h in tr.history[-n_fr:]]))
            log(f"  {feature} {f'on, lr {lr:g}' if on else 'off'}, {n_fr} "
                f"cameras: {n_it} steps ({n_it // n_fr} a frame) in "
                f"{time.perf_counter() - t0:.1f} s (graph captures "
                + ", ".join(f"{c:.2f}" for c in
                            tr._fused_steps_fn.capture_seconds)
                + f" s), training psnr over one visit of each frame by "
                f"step: " + " ".join(
                    f"{i}:{np.mean([h['psnr'] for h in tr.history[i:i + n_fr]]):.2f}"
                    for i in range(0, n_it, n_it // 6))
                + f" -> {psnrs[on]:.2f}")
        log(f"  {feature}, {n_fr} cameras, {n_it} steps, lr {lr:g}: "
            f"post-correction {psnrs[True]:.2f} against {psnrs[False]:.2f} "
            f"dB off ("
            + ("the gate" if gate else "reported, not gated") + ")")
        if gate and not psnrs[True] > psnrs[False]:
            raise AssertionError(f"{feature}: post-correction PSNR "
                                 f"{psnrs[True]:.2f} does not beat "
                                 f"{psnrs[False]:.2f}")
        res_out[f"{feature}_{n_it}steps_lr{lr:g}_psnr"] = (psnrs[False],
                                                          psnrs[True])
        return psnrs

    colour_runs("exposure", tinted, 300, 5e-3, True)
    grid_300 = colour_runs("bilateral_grid", darkened, 300, 5e-3, False)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cli_train.main(["--synthetic", str(n_syn), "--iterations", "600",
                        "--capacity", "65536", "--exposure",
                        "--bilateral-grid", "--output", tmp])
        cli_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "train_summary.json")) as fh:
            hist = json.load(fh)["history"]
        view = os.path.join(tmp, "trained.png")
        composite_fwd.launches = 0
        cli_render.main([os.path.join(tmp, "scene.ply"), "--output", view,
                         "--eye", "4", "0", "1", "--width", "256",
                         "--height", "256"])
        img = read_png_rgb(view)
    log(f"  cli.train --synthetic {n_syn} --iterations 600 --capacity 65536 "
        f"--exposure --bilateral-grid: {cli_s:.1f} s, psnr by log step "
        + " ".join(f"{h['step']}:{h['psnr']:.2f}" for h in hist)
        + f"; scene.ply rendered 256x256, std {img.std():.1f}")
    if not hist[-1]["psnr"] > hist[0]["psnr"]:
        raise AssertionError("cli.train with colour correction did not "
                             "raise PSNR")
    if img.shape != (256, 256, 3) or int(img.std() * 1000) == 0 \
            or composite_fwd.launches != 1:
        raise AssertionError("the trained scene did not render")

    # 11c. fused_steps at the bench workload: eager steps against replays
    g, cam, cfg = bench_scene(dev)
    res = cam.width
    bench_frames = [Frame(camera=cam, image=np.zeros((res, res, 3),
                                                     np.float32))]
    cfg_b = TrainConfig(render=cfg, impl="tiled", sh_warmup_every=1,
                        densify_from=10**9, opacity_reset_interval=10**9,
                        dynamic_pool=False, log_every=10**9)
    n_steps = 100
    step_stats = {}
    for fused in (0, 10):
        tr = Trainer(dataclasses.replace(cfg_b, fused_steps=fused), g,
                     bench_frames)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr.run(iterations=20, progress=False)      # warm; the capture
        torch.cuda.synchronize()
        mem1, peak = torch.cuda.memory_allocated(), \
            torch.cuda.max_memory_allocated()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        tr.run(iterations=n_steps, progress=False)
        stop.record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / n_steps
        events_ms = start.elapsed_time(stop) / n_steps
        # busy and wall from one profiled window: the union of the
        # device's intervals in the trace over the window's host wall
        n_prof = 20
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.run(iterations=n_prof, progress=False)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3 / n_prof
        events = device_rows(prof)
        n_kern = sum(e.count for e in events) / n_prof
        per_kernel = kernel_counts(prof, n_prof)
        union, summed, _ = trace_busy(prof)
        busy, summed = union / n_prof, summed / n_prof
        capture = (tr._fused_steps_fn.capture_seconds if fused else [])
        step_stats[fused] = dict(host=host, events=events_ms, busy=busy,
                                 summed=summed, prof_wall=prof_wall,
                                 idle=1 - busy / prof_wall, kernels=n_kern,
                                 per_kernel=per_kernel)
        log(f"  bench train step {'graph replay (fused_steps 10)' if fused else 'eager'}"
            f": host wall {host:.4f} ms, CUDA events {events_ms:.4f} ms; "
            f"profiled window: host wall {prof_wall:.4f} ms, device busy "
            f"{busy:.4f} ms (union of the trace's intervals; summed "
            f"{summed:.4f}), {n_kern:.1f} kernels a step (composite_fwd "
            f"{per_kernel['composite_fwd']:.2f}, composite_bwd "
            f"{per_kernel['composite_bwd']:.2f}), idle share "
            f"{1 - busy / prof_wall:.3f}; memory {mem0 / 2**20:.1f} -> "
            f"{mem1 / 2**20:.1f} MiB held, peak {peak / 2**20:.1f} MiB"
            + (f"; capture {capture[0]:.3f} s" if capture else ""))
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"    {e.self_device_time_total / 1e3 / n_prof:8.4f} ms "
                f"x{e.count / n_prof:<6.1f} {e.key[:80]}")
        del tr
    graphed = step_stats[10]["per_kernel"]
    if min(graphed.values()) < 1.0:
        raise AssertionError(f"the graphed step launched no compositing "
                             f"kernel: {graphed}")
    res_out["graph_launches_per_step"] = graphed
    res_out["graph_steps"] = step_stats

    # step for step: fused_steps 10 against 0 on the synthetic scene,
    # across densify rounds (30, 60), a pool resize (30) and an opacity
    # reset (60)
    runs = {}
    for fused in (0, 10):
        cfg_s = TrainConfig(iterations=120, render=rcfg, scene_extent=extent,
                            log_every=5, densify_from=30, densify_until=90,
                            densify_interval=30, opacity_reset_interval=60,
                            fused_steps=fused)
        tr = Trainer(cfg_s, Gaussians.from_points(
            pts, sh_degree=3, capacity=65536, device=dev),
            [Frame(camera=f.camera, image=c) for f, c in zip(frames, clean)])
        tr.run(progress=False)
        torch.cuda.synchronize()
        runs[fused] = tr
    a, b = runs[10], runs[0]
    loss_err = max(abs(x["loss"] - y["loss"]) / max(abs(y["loss"]), 1e-12)
                   for x, y in zip(a.history, b.history))
    diffs = {k: float((getattr(a.state.gaussians, k)
                       - getattr(b.state.gaussians, k)).abs().max())
             for k in ("means", "quats", "log_scales", "logit_opacities",
                       "sh_dc", "sh_rest")}
    equal = all(torch.equal(getattr(a.state.gaussians, f.name),
                            getattr(b.state.gaussians, f.name))
                for f in dataclasses.fields(a.state.gaussians)) and all(
        x["loss"] == y["loss"] for x, y in zip(a.history, b.history))
    log(f"  fused_steps 10 vs 0, 120 steps (densify at 30 and 60, pool "
        f"{b.state.gaussians.capacity} after the resize, opacity reset at "
        f"60, {len(a._fused_steps_fn.capture_seconds)} captures): "
        f"{len(a.history)} logged losses, max relative difference "
        f"{loss_err:.3e}; max|diff| "
        + " ".join(f"{k} {v:.3e}" for k, v in diffs.items())
        + f"; bit-equal: {equal}; alive {int(a.state.gaussians.num_alive)}")
    if [h["step"] for h in a.history] != [h["step"] for h in b.history] \
            or len(a._fused_steps_fn.capture_seconds) < 2:
        raise AssertionError("the fused run logged other steps or never "
                             "captured a resized pool")
    for k in ("means", "quats", "log_scales", "sh_dc", "sh_rest"):
        if not torch.allclose(getattr(a.state.gaussians, k),
                              getattr(b.state.gaussians, k), rtol=1e-5,
                              atol=1e-6):
            raise AssertionError(f"fused {k} differ from the eager run's")
    if not torch.allclose(a.state.gaussians.logit_opacities,
                          b.state.gaussians.logit_opacities, rtol=1e-5,
                          atol=1e-5) or any(
            abs(x["loss"] - y["loss"]) > 1e-5 * abs(y["loss"]) + 1e-6
            for x, y in zip(a.history, b.history)):
        raise AssertionError("the fused run's opacities or losses differ")
    res_out["fused_equal"] = equal
    del runs, a, b

    # 11d. composite_tiled_batch at the rollout workload, with the mesh's
    # depth limit at step 0
    g_r, cams, cfg_r = rollout_scene(dev)
    W, H = cams[0].width, cams[0].height
    tx, ty = num_tiles(W, H, cfg_r.tile_size)
    with tempfile.TemporaryDirectory() as tmp:
        obj = ArticulatedObject.from_urdf(write_rollout_object(tmp))
        traj_path, _ = write_rollout_inputs(tmp, obj.model)
        traj, poses = load_trajectory(traj_path, [obj.model])
    with torch.no_grad():
        meshes = obj.posed_meshes(traj[0], base_pose=poses[0, 0], device=dev)
        depth = torch.stack([merge_mesh_layers([
            {k: o[k] for k in ("rgb", "depth", "mask", "face_id")}
            for o in (rasterize_mesh(v, f, c, vertex_colors=col,
                                     cfg=ROLLOUT_MESH)
                      for v, f, col in meshes)])["depth"] for c in cams])
        projs = stack_projected([project(g_r, c, cfg_r) for c in cams])
        composite_fwd.launches = composite_bwd.launches = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out_b = composite_tiled_batch(projs, W, H, cfg_r,
                                          return_stats=True,
                                          depth_limit=depth)
            torch.cuda.synchronize()
        batch_launches = composite_fwd.launches
        prof_fwd = kernel_counts(prof, 1)["composite_fwd"]
        singles = [composite_tiled(project(g_r, c, cfg_r), W, H, cfg_r,
                                   depth_limit=depth[i])
                   for i, c in enumerate(cams)]
        img_err = max(float((out_b[k][i] - singles[i][k]).abs().max())
                      for i in range(len(cams))
                      for k in ("rgb", "alpha", "depth"))
        img_equal = all(torch.equal(out_b[k][i], singles[i][k])
                        for i in range(len(cams))
                        for k in ("rgb", "alpha", "depth"))
    trunc_b = [int(x) for x in out_b["stats"].truncated_gaussians]
    log(f"  composite_tiled_batch {len(cams)} x {W}x{H} ({len(cams)} x "
        f"{tx * ty} tiles): wrapper launches {batch_launches}, profiler "
        f"composite_fwd kernels {prof_fwd:.0f}; truncated splats per camera "
        f"{trunc_b}; against {len(cams)} composite_tiled calls max|err| "
        f"{img_err:.3e}, bit-equal {img_equal}")
    if batch_launches != 1 or prof_fwd != 1 or any(trunc_b):
        raise AssertionError("the batch did not composite in one launch")
    if img_err > 1e-6:
        raise AssertionError("the batch differs from per-camera composites")
    # the kernel against its plain version at this shape
    with torch.no_grad():
        binned = [bin_and_gather_packed(project(g_r, c, cfg_r), W, H, cfg_r)
                  for c in cams]
        geom_b = torch.cat([x[0] for x in binned])
        feat_b = torch.cat([x[1] for x in binned])
        counts_b = torch.cat([x[2] for x in binned])
        dlim_b = torch.cat([tile_image(d, tx, ty, cfg_r.tile_size,
                                       pad_value=float("inf"))
                            for d in depth])[..., None].contiguous()
        T = tx * ty
        kw_b = dict(tiles_x=tx, cfg=cfg_r, n_tiles_per_image=T, has_dlim=True)
        got_b = composite_fwd(geom_b, feat_b, counts_b, dlim_b, **kw_b)
        torch.cuda.synchronize()
        batch_err, _ = compare_fwd(got_b, composite_fwd_plain(
            geom_b, feat_b, counts_b, dlim_b, **kw_b),
            f"batch {len(cams)} x {W}x{H} mesh depth limit",
            (geom_b, counts_b, dlim_b, kw_b))
    # the gradient w.r.t. the projections against the per-camera sum
    fields = ("means2d", "conics", "colors", "opacities")
    wts = torch.randn((len(cams), H, W, 3),
                      generator=torch.Generator().manual_seed(31)).to(dev)
    leaves = {f: getattr(projs, f).clone().requires_grad_(True)
              for f in fields}
    composite_bwd.launches = 0
    (composite_tiled_batch(dataclasses.replace(projs, **leaves), W, H, cfg_r,
                           depth_limit=depth)["rgb"] * wts).sum().backward()
    torch.cuda.synchronize()
    bwd_batch_launches = composite_bwd.launches
    each = {f: getattr(projs, f).clone().requires_grad_(True) for f in fields}
    for i in range(len(cams)):
        p_i = Projected(**{fl.name: (each[fl.name][i] if fl.name in each
                                     else None if getattr(projs, fl.name)
                                     is None else getattr(projs, fl.name)[i])
                           for fl in dataclasses.fields(Projected)})
        (composite_tiled(p_i, W, H, cfg_r, depth_limit=depth[i])["rgb"]
         * wts[i]).sum().backward()
    grad_errs = {f: (float((leaves[f].grad - each[f].grad).abs().max()),
                     float(each[f].grad.abs().max())) for f in fields}
    log(f"  batch gradient ({bwd_batch_launches} backward launch) against "
        f"the per-camera sum: "
        + ", ".join(f"{f} {e:.3e} of {m:.3e}" for f, (e, m)
                    in grad_errs.items()))
    if bwd_batch_launches != 1 or any(e > 1e-3 * m or m == 0.0
                                      for e, m in grad_errs.values()):
        raise AssertionError("the batch's gradient differs from the "
                             "per-camera sum")
    del leaves, each
    with torch.no_grad():
        batch_ms = time_ms(lambda: composite_fwd(geom_b, feat_b, counts_b,
                                                 dlim_b, **kw_b), reps=100)
        batch_plain_ms = time_ms(lambda: composite_fwd_plain(
            geom_b, feat_b, counts_b, dlim_b, **kw_b), reps=2, warmup=1)
        singles_ms = sum(time_ms(lambda i=i: composite_fwd(
            geom_b[i * T:(i + 1) * T], feat_b[i * T:(i + 1) * T],
            counts_b[i * T:(i + 1) * T], dlim_b[i * T:(i + 1) * T],
            tiles_x=tx, cfg=cfg_r, has_dlim=True), reps=100)
            for i in range(len(cams)))
        frame_batch_ms = time_ms(lambda: composite_tiled_batch(
            stack_projected([project(g_r, c, cfg_r) for c in cams]), W, H,
            cfg_r, depth_limit=depth), reps=10)
        frame_single_ms = time_ms(lambda: [composite_tiled(
            project(g_r, c, cfg_r), W, H, cfg_r, depth_limit=depth[i])
            for i, c in enumerate(cams)], reps=10)
        batch_bound_ms, batch_bound_by, batch_detail, _ = fwd_bound(
            geom_b, counts_b, got_b[2], dlim_b, tx, cfg_r, T)
    log(f"  composite_fwd on {geom_b.shape[0]} tiles {batch_ms:.4f} ms "
        f"against 4 single-camera launches {singles_ms:.4f} ms, plain "
        f"{batch_plain_ms:.4f} ms; bound {batch_bound_ms:.6f} ms "
        f"({batch_detail}), share {batch_bound_ms / batch_ms:.4f}; "
        f"projections + composite_tiled_batch {frame_batch_ms:.4f} ms "
        f"against 4 x (project + composite_tiled) {frame_single_ms:.4f} ms")
    res_out.update(batch_launches=batch_launches, batch_ms=batch_ms,
                   batch_plain_ms=batch_plain_ms,
                   batch_bound_ms=batch_bound_ms,
                   batch_max_abs_err=batch_err)
    del g_r, projs, out_b, singles, binned, geom_b, feat_b

    # 11e. on 32x32 tiles: tile32
    res_out.update(tile32(dev, smi))

    # 11f. the grid's gate: 11b's run at lr 1e-3 against 11b's off run.
    # The JAX test's lr 5e-3 (4 cameras, 40 Gaussians) loses on 24
    # cameras, and more steps widen the gap (PERF.md): the 600-step
    # pair is reported
    colour_runs("bilateral_grid", darkened, 300, 1e-3, True,
                off=grid_300[False])
    colour_runs("bilateral_grid", darkened, 600, 5e-3, False)
    log(f"  phase 11 {time.perf_counter() - t11:.1f} s")
    return res_out


def tile32(dev, smi: str) -> dict:
    """Phase 11e: the bench view on 32x32 tiles (the JAX package's tile
    size for its 3M-Gaussian config) at the capacities
    recommend_capacities measures for it: the nblk distribution, both
    kernels against their plain versions (the backward's split kernel
    without and with a depth limit, and with absgrad; two launches
    bit-equal), their times and bounds; Trainer steps there, the same
    steps as a CUDA graph bit-equal to them, the step's device time by
    operation, and a small scene's gradients card against CPU. Returns
    the numbers of the kernels line."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from robosimgs_tpu_torch import Camera, Gaussians
    from robosimgs_tpu_torch.render.autotune import recommend_capacities
    from robosimgs_tpu_torch.render.binning import bin_and_gather_packed
    from robosimgs_tpu_torch.render.config import RenderConfig
    from robosimgs_tpu_torch.render.kernels import (bwd_splits,
                                                    composite_bwd,
                                                    composite_bwd_plain,
                                                    composite_fwd,
                                                    composite_fwd_plain)
    from robosimgs_tpu_torch.render.project import project
    from robosimgs_tpu_torch.render.tiled import composite_tiled
    from robosimgs_tpu_torch.render.tiles import num_tiles
    from robosimgs_tpu_torch.tools.workloads import bench_scene, time_ms
    from robosimgs_tpu_torch.train.data import Frame
    from robosimgs_tpu_torch.train.losses import photometric_loss
    from robosimgs_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                   make_train_step)

    out = {}
    g, cam, _ = bench_scene(dev)
    res = cam.width
    bench_frames = [Frame(camera=cam, image=np.zeros((res, res, 3),
                                                     np.float32))]
    cfg32 = recommend_capacities(g, [cam], base=RenderConfig(tile_size=32))
    with torch.no_grad():
        geom_w, feat_w, counts_w, st32 = bin_and_gather_packed(
            project(g, cam, cfg32), res, res, cfg32)
        tx32 = num_tiles(res, res, 32)[0]
        T32, K32 = geom_w.shape[0], geom_w.shape[2]
        kw_w = dict(tiles_x=tx32, cfg=cfg32, has_dlim=False)
        fwd_w = composite_fwd(geom_w, feat_w, counts_w, None, **kw_w)
        torch.cuda.synchronize()
        splits32 = bwd_splits(T32, K32, 1024, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        log(f"  32x32 tiles at the trainer's capacities: T={T32} K={K32} "
            f"(backward: {splits32} blocks a tile), counts max "
            f"{int(counts_w.max())}; {nblk_histogram(fwd_w[2])}")
        fwd_err = compare_fwd(fwd_w, composite_fwd_plain(
            geom_w, feat_w, counts_w, None, **kw_w), f"32x32 tiles K={K32}",
            (geom_w, counts_w, None, kw_w))[0]
        quadrant_check(geom_w, feat_w, counts_w, None, fwd_w, kw_w,
                       f"32x32 tiles K={K32}")
        gout_w = torch.randn(fwd_w[0].shape, generator=torch.Generator()
                             .manual_seed(32)).to(dev)
        args_w = (geom_w, feat_w, counts_w, None, gout_w, *fwd_w[1:])
        got_w = composite_bwd(*args_w, **kw_w)
        again = composite_bwd(*args_w, **kw_w)
        torch.cuda.synchronize()
        bwd_err = compare_bwd(got_w, composite_bwd_plain(*args_w, **kw_w),
                              f"bwd 32x32 tiles K={K32}")
        if not all(torch.equal(a, b) for a, b in zip(got_w, again)):
            raise AssertionError("two launches of the split backward differ")
        dlim_w = (torch.rand((T32, 1024, 1), generator=torch.Generator()
                             .manual_seed(33)) * 4.0 + 2.0).to(dev)
        kw_d = dict(kw_w, has_dlim=True)
        fwd_d = composite_fwd(geom_w, feat_w, counts_w, dlim_w, **kw_d)
        quadrant_check(geom_w, feat_w, counts_w, dlim_w, fwd_d, kw_d,
                       f"32x32 tiles K={K32} dlim")
        args_d = (geom_w, feat_w, counts_w, dlim_w, gout_w, *fwd_d[1:])
        bwd_err = max(bwd_err, compare_bwd(
            composite_bwd(*args_d, **kw_d),
            composite_bwd_plain(*args_d, **kw_d), f"bwd 32x32 K={K32} dlim"))
        cfg32a = dataclasses.replace(cfg32, absgrad=True)
        geom_a, feat_a, counts_a, _ = bin_and_gather_packed(
            project(g, cam, cfg32a, abs_probe=torch.zeros(
                (g.capacity, 2), device=dev)), res, res, cfg32a)
        kw_a = dict(kw_w, cfg=cfg32a)
        fwd_a = composite_fwd(geom_a, feat_a, counts_a, None, **kw_a)
        args_a = (geom_a, feat_a, counts_a, None, gout_w, *fwd_a[1:])
        got_a = composite_bwd(*args_a, **kw_a)
        torch.cuda.synchronize()
        bwd_err = max(bwd_err, compare_bwd(
            got_a, composite_bwd_plain(*args_a, **kw_a),
            f"bwd 32x32 K={K32} absgrad"))
        if float(got_a[0][:, 7].max()) <= 0.0:
            raise AssertionError("32x32 absgrad rows are empty")
        del geom_a, feat_a, fwd_a, args_a, got_a, fwd_d, args_d, again
        tile32_ms = time_ms(lambda: composite_bwd(*args_w, **kw_w), reps=100)
        tile32_plain_ms = time_ms(lambda: composite_bwd_plain(
            *args_w, **kw_w), reps=2, warmup=1)
        fwd32_ms = time_ms(lambda: composite_fwd(geom_w, feat_w, counts_w,
                                                 None, **kw_w), reps=100)
        fwd32_plain_ms = time_ms(lambda: composite_fwd_plain(
            geom_w, feat_w, counts_w, None, **kw_w), reps=2, warmup=1)
        fwd32_bound_ms, fwd32_bound_by, fwd32_detail, work32 = fwd_bound(
            geom_w, counts_w, fwd_w[2], None, tx32, cfg32)
        skip32 = skipped_pairs(geom_w, feat_w, counts_w, tx32, cfg32)
        tile32_bound_ms, tile32_bound_by, tile32_detail = bwd_bound(
            geom_w, counts_w, fwd_w[2], None, tx32, cfg32, work32)
    log(f"  composite_fwd on 32x32 tiles (T={T32}, K={K32}) {fwd32_ms:.4f} "
        f"ms, plain {fwd32_plain_ms:.4f} ms; bound {fwd32_bound_ms:.6f} ms "
        f"({fwd32_detail}), share {fwd32_bound_ms / fwd32_ms:.4f}; "
        f"{skip_line(skip32)} ({smi})")
    log(f"  composite_bwd on 32x32 tiles (T={T32}, K={K32}, {splits32} "
        f"blocks a tile) {tile32_ms:.4f} ms, plain {tile32_plain_ms:.4f} "
        f"ms; bound {tile32_bound_ms:.6f} ms ({tile32_detail}), share "
        f"{tile32_bound_ms / tile32_ms:.4f}; library call: none ({smi})")
    out.update(tile32_ms=tile32_ms, tile32_plain_ms=tile32_plain_ms,
                   tile32_bound_ms=tile32_bound_ms,
                   tile32_bound_by=tile32_bound_by, tile32_K=K32,
                   tile32_splits=splits32,
                   tile32_max_abs_err=bwd_err, tile32_fwd_max_abs_err=fwd_err,
                   tile32_fwd_ms=fwd32_ms, tile32_fwd_plain_ms=fwd32_plain_ms,
                   tile32_fwd_bound_ms=fwd32_bound_ms,
                   tile32_fwd_bound_by=fwd32_bound_by,
                   tile32_fwd_skipped_share=(skip32["skipped"]
                                             / skip32["processed"]))
    del geom_w, feat_w, fwd_w, gout_w, args_w, got_w
    cfg_t32 = TrainConfig(render=cfg32, impl="tiled", sh_warmup_every=1,
                          densify_from=10**9, opacity_reset_interval=10**9,
                          dynamic_pool=False, log_every=1)
    tr = Trainer(cfg_t32, g, bench_frames)
    composite_fwd.launches = composite_bwd.launches = 0
    tr.run(iterations=3, progress=False)
    torch.cuda.synchronize()
    l32 = (composite_fwd.launches, composite_bwd.launches)
    losses = [h["loss"] for h in tr.history]
    log(f"  Trainer 3 steps on 32x32 tiles: K={cfg32.tile_capacity} M="
        f"{cfg32.max_tiles_per_gaussian} (recommend_capacities), truncated "
        f"{int(st32.truncated_gaussians)}, overflowed tiles "
        f"{int(st32.overflowed_tiles)}, launches {l32}, loss "
        + " ".join(f"{x:.6f}" for x in losses)
        + f", overflow {[h['overflow'] for h in tr.history]}")
    if int(st32.truncated_gaussians) or int(st32.overflowed_tiles) \
            or l32 != (3, 3) or not all(np.isfinite(losses)):
        raise AssertionError("the 32x32-tile train steps failed")
    # the same 3 steps as one CUDA graph replayed 3 times: bit for bit
    trg = Trainer(dataclasses.replace(cfg_t32, fused_steps=3), g,
                  bench_frames)
    trg.run(iterations=3, progress=False)
    torch.cuda.synchronize()
    graph_equal = all(
        torch.equal(getattr(trg.state.gaussians, f.name),
                    getattr(tr.state.gaussians, f.name))
        for f in dataclasses.fields(tr.state.gaussians)) and [
        h["loss"] for h in trg.history] == losses
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trg.run(iterations=3, progress=False)
        torch.cuda.synchronize()
    kc32 = kernel_counts(prof, 3)
    log(f"  32x32 graphed steps (fused_steps 3, "
        f"{len(trg._fused_steps_fn.capture_seconds)} capture) against the "
        f"eager steps: bit-equal {graph_equal}; kernels a replayed step "
        f"composite_fwd {kc32['composite_fwd']:.2f} composite_bwd "
        f"{kc32['composite_bwd']:.2f}")
    if not graph_equal or min(kc32.values()) < 1.0:
        raise AssertionError("the graphed 32x32 step is not the eager one")
    del trg
    # where the 32x32 step's device time goes
    step32, st = make_train_step(cfg_t32, "tiled"), tr.state
    tgt = torch.zeros((res, res, 3), device=dev)
    step32(st, cam, tgt)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            st, _ = step32(st, cam, tgt)
        torch.cuda.synchronize()
    out["tile32_step_ops"] = device_ops(prof, 2, "32x32 train step")
    del tr, st
    small = Gaussians.random(torch.Generator().manual_seed(2), 2000,
                             sh_degree=3, extent=1.5, device=dev)
    small = small.replace(log_scales=small.log_scales + 0.5 * torch.randn(
        small.log_scales.shape, generator=torch.Generator().manual_seed(6)
    ).to(dev))
    cam_s = Camera.look_at([4.0, 0.5, 1.2], [0, 0, 0], [0, 0, 1], 60.0, 64,
                           48, device=dev)
    cfg_s = RenderConfig(tile_size=32, tile_capacity=1024)
    grads = {}
    for d in ("cpu", "cuda"):
        gg = small.to(d)
        params = {k: getattr(gg, k).clone().requires_grad_()
                  for k in ("means", "quats", "log_scales", "logit_opacities",
                            "sh_dc", "sh_rest")}
        out_g = composite_tiled(project(gg.replace(**params), cam_s.to(d),
                                        cfg_s), 64, 48, cfg_s)
        photometric_loss(out_g["rgb"], torch.full((48, 64, 3), 0.3,
                                                  device=d)).backward()
        grads[d] = {k: v.grad.cpu() for k, v in params.items()}
    for k, want_g in grads["cpu"].items():
        e = float((grads["cuda"][k] - want_g).abs().max())
        scale = float(want_g.abs().max())
        log(f"  32x32 grad {k}: max|card - cpu| {e:.3e} of max {scale:.3e}")
        if e > 1e-3 * scale:
            raise AssertionError(f"{k} gradients differ on the card at 32x32")

    return out


def feasibility(dev, smi: str) -> dict:
    """Phase 13: the JAX package's largest single-chip scene, the
    counterpart of scripts/feasibility_3m.py (tools/workloads.py
    feasibility_scene: 3M Gaussians, SH 3, 512x512, 32-px tiles, K=2048,
    M=16, bbox 20). Gates: the render at K=2048 against K=4096 above 60
    dB (the script's capacity-doubling gate) and no truncated Gaussian.
    Both kernels against their plain versions on this shape's residuals,
    their times and bounds; 5 train steps against a zero target through
    the Trainer (one launch of each kernel a step, finite losses), the
    step's ms by CUDA events, peak memory, and its device time by
    operation from one profiled step. Returns the numbers of the kernels
    line."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from robosimgs_tpu_torch.render.binning import bin_and_gather_packed
    from robosimgs_tpu_torch.render.kernels import (bwd_splits,
                                                    composite_bwd,
                                                    composite_bwd_plain,
                                                    composite_fwd,
                                                    composite_fwd_plain)
    from robosimgs_tpu_torch.render.project import project
    from robosimgs_tpu_torch.render.rasterize import rasterize
    from robosimgs_tpu_torch.render.tiles import num_tiles
    from robosimgs_tpu_torch.tools.workloads import (feasibility_config,
                                                     feasibility_scene,
                                                     time_ms)
    from robosimgs_tpu_torch.train.data import Frame
    from robosimgs_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                   make_train_step)

    t13 = time.perf_counter()
    g, cam, cfg = feasibility_scene(dev)
    res = cam.width
    torch.cuda.synchronize()
    log(f"[13 feasibility] {g.capacity} Gaussians SH 3 at {res}x{res}, "
        f"tile {cfg.tile_size} K={cfg.tile_capacity} M="
        f"{cfg.max_tiles_per_gaussian} bbox {cfg.bbox_tiles_per_gaussian} "
        f"({time.perf_counter() - t13:.1f} s to make)")
    # the capacity-doubling gate, and no truncation at either K
    rgb = {}
    with torch.no_grad():
        for k in (4096, 2048):
            out = rasterize(g, cam, feasibility_config(k), impl="tiled",
                            return_stats=True)
            st = out["stats"]
            log(f"  K={k}: truncated {int(st.truncated_gaussians)}, "
                f"overflowed tiles {int(st.overflowed_tiles)}, max tile count "
                f"{int(st.max_tile_count)}, pairs {int(st.total_pairs)}")
            if int(st.truncated_gaussians) != 0:
                raise AssertionError(f"the 3M config truncates at K={k}")
            rgb[k] = out["rgb"]
    gate_db = psnr(rgb[2048], rgb[4096])
    log(f"  K=2048 against K=4096 (capacity doubling): {gate_db:.2f} dB")
    if gate_db <= 60.0:
        raise AssertionError(f"K=2048 at {gate_db} dB of K=4096")
    del rgb
    # both kernels against their plain versions at this shape
    with torch.no_grad():
        geom, feat, counts, _ = bin_and_gather_packed(
            project(g, cam, cfg), res, res, cfg)
        T, K = geom.shape[0], geom.shape[2]
        tx = num_tiles(res, res, cfg.tile_size)[0]
        kw = dict(tiles_x=tx, cfg=cfg, has_dlim=False)
        fwd = composite_fwd(geom, feat, counts, None, **kw)
        torch.cuda.synchronize()
        splits = bwd_splits(T, K, cfg.tile_size ** 2,
                            torch.cuda.get_device_properties(dev)
                            .multi_processor_count)
        log(f"  T={T} K={K} (backward: {splits} block(s) a tile); "
            f"{nblk_histogram(fwd[2])}")
        fwd_err = compare_fwd(fwd, composite_fwd_plain(
            geom, feat, counts, None, **kw), "3M 512x512",
            (geom, counts, None, kw))[0]
        quadrant_check(geom, feat, counts, None, fwd, kw, "3M 512x512")
        gout = torch.randn(fwd[0].shape, generator=torch.Generator()
                           .manual_seed(13)).to(dev)
        args = (geom, feat, counts, None, gout, *fwd[1:])
        got = composite_bwd(*args, **kw)
        again = composite_bwd(*args, **kw)
        torch.cuda.synchronize()
        bwd_err = compare_bwd(got, composite_bwd_plain(*args, **kw),
                              "bwd 3M 512x512")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("two backward launches differ at 3M")
        del got, again
        fwd_ms = time_ms(lambda: composite_fwd(geom, feat, counts, None,
                                               **kw), reps=100)
        fwd_plain_ms = time_ms(lambda: composite_fwd_plain(
            geom, feat, counts, None, **kw), reps=2, warmup=1)
        bwd_ms = time_ms(lambda: composite_bwd(*args, **kw), reps=100)
        bwd_plain_ms = time_ms(lambda: composite_bwd_plain(*args, **kw),
                               reps=2, warmup=1)
        fb_ms, fb_by, fb_detail, work = fwd_bound(geom, counts, fwd[2], None,
                                                  tx, cfg)
        bb_ms, bb_by, bb_detail = bwd_bound(geom, counts, fwd[2], None, tx,
                                            cfg, work)
        skip = skipped_pairs(geom, feat, counts, tx, cfg)
    log(f"  composite_fwd {fwd_ms:.4f} ms, plain {fwd_plain_ms:.4f} ms; bound "
        f"{fb_ms:.6f} ms ({fb_detail}), share {fb_ms / fwd_ms:.4f}; "
        f"{skip_line(skip)} ({smi})")
    log(f"  composite_bwd {bwd_ms:.4f} ms, plain {bwd_plain_ms:.4f} ms; bound "
        f"{bb_ms:.6f} ms ({bb_detail}), share {bb_ms / bwd_ms:.4f}; library "
        f"call: none ({smi})")
    del geom, feat, counts, fwd, gout, args
    # 5 train steps against a zero target
    cfg_t = TrainConfig(render=cfg, impl="tiled", sh_warmup_every=1,
                        densify_from=10**9, opacity_reset_interval=10**9,
                        dynamic_pool=False, log_every=1)
    tr = Trainer(cfg_t, g, [Frame(camera=cam, image=np.zeros(
        (res, res, 3), np.float32))])
    del g
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    composite_fwd.launches = composite_bwd.launches = 0
    tr.run(iterations=5, progress=False)
    torch.cuda.synchronize()
    launches = (composite_fwd.launches, composite_bwd.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in tr.history]
    step_fn, st = make_train_step(cfg_t, "tiled"), tr.state
    tgt = torch.zeros((res, res, 3), device=dev)

    def train_step():
        nonlocal st
        st, _ = step_fn(st, cam, tgt)

    step_ms = time_ms(train_step, reps=5, warmup=1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_step()
        torch.cuda.synchronize()
    log(f"  Trainer 5 steps: launches {launches}, loss "
        + " ".join(f"{x:.6f}" for x in losses)
        + f", overflow {[h['overflow'] for h in tr.history]}; step "
        f"{step_ms:.4f} ms (CUDA events, mean of 5); peak memory "
        f"{peak / 2**30:.3f} GiB ({smi})")
    ops = device_ops(prof, 1, "3M train step")
    if launches != (5, 5) or not all(np.isfinite(losses)):
        raise AssertionError("the 3M train steps failed")
    log(f"  phase 13 {time.perf_counter() - t13:.1f} s")
    return dict(launches=launches, fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain_ms,
                fwd_bound_ms=fb_ms, fwd_bound_by=fb_by,
                fwd_skipped_share=skip["skipped"] / skip["processed"],
                fwd_max_abs_err=fwd_err, bwd_ms=bwd_ms,
                bwd_plain_ms=bwd_plain_ms, bwd_bound_ms=bb_ms,
                bwd_bound_by=bb_by, bwd_max_abs_err=bwd_err, splits=splits,
                gate_db=gate_db, step_ms=step_ms, peak_bytes=peak,
                step_ops=ops)


def measure(dev, smi: str) -> dict:
    """Phase 14: the unpacked binner and the port's measurement tools.
    (a) bin_gaussians + gather_tile_features at the bench width with the
    exact cull off and one tier against bin_and_gather_packed: the same
    live selection, geom and feat, one forward launch and a bit-equal
    render through composite_from_tiles, zero truncation, per-Gaussian
    gradients through Composite within 1e-5 of the largest, and the
    forward kernel against its plain version on those blocks.
    (b) tools/profile_stages.py at the bench config and at the 3M config.
    (c) tools/k_equiv.py on the bench scene with the JAX script's K list.
    (d) tools/staged_lossless.py on the 1M 512x512 staged workload (its
    gates and truncation asserts), then both kernels against their plain
    versions at the staged K 384 two-tier shape and the forward at the
    lossless K on half its tiles, with times and bounds. Returns the
    numbers of the kernels line."""
    import dataclasses

    import torch

    from robosimgs_tpu_torch.render.binning import (bin_and_gather_packed,
                                                    bin_gaussians,
                                                    gather_tile_features)
    from robosimgs_tpu_torch.render.kernels import (composite_bwd,
                                                    composite_bwd_plain,
                                                    composite_fwd,
                                                    composite_fwd_plain)
    from robosimgs_tpu_torch.render.project import project
    from robosimgs_tpu_torch.render.tiled import (composite_from_tiles,
                                                  composite_tiled)
    from robosimgs_tpu_torch.render.tiles import num_tiles
    from robosimgs_tpu_torch.tools import (k_equiv, profile_stages,
                                           staged_lossless, workloads)
    from robosimgs_tpu_torch.tools.workloads import time_ms
    from robosimgs_tpu_torch.train.losses import photometric_loss
    from robosimgs_tpu_torch.train.optim import FLOAT_FIELDS

    t14 = time.perf_counter()
    out = {}
    # (a) the unpacked binner against the packed one
    g, cam, cfg = workloads.bench_scene(dev)
    res = cam.width
    cfg_a = dataclasses.replace(cfg, exact_tile_cull=False, two_tier_split=0)
    tx = num_tiles(res, res, cfg_a.tile_size)[0]
    with torch.no_grad():
        proj = project(g, cam, cfg_a)
        sel, counts, st = bin_gaussians(proj, res, res, cfg_a)
        geom, feat = gather_tile_features(proj, sel, counts, cfg_a)
        pgeom, pfeat, pcounts, pst, psel = bin_and_gather_packed(
            proj, res, res, cfg_a, return_sel=True)
        live = (torch.arange(sel.shape[1], device=dev)[None, :]
                < counts[:, None])
        same = (torch.equal(counts, pcounts)
                and torch.equal(sel[live], psel[live])
                and torch.equal(geom.transpose(1, 2)[live],
                                pgeom.transpose(1, 2)[live])
                and torch.equal(feat.transpose(1, 2)[live],
                                pfeat.transpose(1, 2)[live])
                and all(int(getattr(st, f.name)) == int(getattr(pst, f.name))
                        for f in dataclasses.fields(st)))
        composite_fwd.launches = 0
        img = composite_from_tiles(geom, feat, counts, res, res, cfg_a)
        torch.cuda.synchronize()
        launches_a = composite_fwd.launches
        pimg = composite_from_tiles(pgeom, pfeat, pcounts, res, res, cfg_a)
        render_equal = all(torch.equal(img[k], pimg[k]) for k in img)
        kw = dict(tiles_x=tx, cfg=cfg_a, has_dlim=False)
        fwd_err = compare_fwd(
            composite_fwd(geom, feat, counts, None, **kw),
            composite_fwd_plain(geom, feat, counts, None, **kw),
            "unpacked blocks", (geom, counts, None, kw))[0]
    log(f"[14 measure] (a) unpacked binner at {res}x{res} K="
        f"{cfg_a.tile_capacity} M={cfg_a.max_tiles_per_gaussian} (exact "
        f"cull off, one tier): live {int(live.sum())} entries, selection, "
        f"geom, feat and BinStats equal to the packed route: {same}; "
        f"truncated {int(st.truncated_gaussians)}, overflowed tiles "
        f"{int(st.overflowed_tiles)}; composite_from_tiles launches "
        f"{launches_a}, render bit-equal to the packed route: {render_equal}")
    if not same or not render_equal or launches_a != 1 \
            or int(st.truncated_gaussians) != 0:
        raise AssertionError("the unpacked binner is not the packed one")
    del proj, sel, geom, feat, pgeom, pfeat, psel, img, pimg, live
    target = torch.zeros((res, res, 3), device=dev)
    grads = {}
    for route in ("unpacked", "packed"):
        params = {k: getattr(g, k).detach().requires_grad_()
                  for k in FLOAT_FIELDS}
        proj = project(g.replace(**params), cam, cfg_a)
        if route == "unpacked":
            sel, counts, _ = bin_gaussians(proj, res, res, cfg_a)
            rgb = composite_from_tiles(*gather_tile_features(
                proj, sel, counts, cfg_a), counts, res, res, cfg_a)["rgb"]
        else:
            rgb = composite_tiled(proj, res, res, cfg_a)["rgb"]
        composite_bwd.launches = 0
        grads[route] = dict(zip(params, torch.autograd.grad(
            photometric_loss(rgb, target), list(params.values()))))
        if composite_bwd.launches != 1:
            raise AssertionError(f"{route}: {composite_bwd.launches} "
                                 f"backward launches")
    # against the largest entry over every field: the quaternions'
    # gradients of the isotropic bench splats sit at rounding noise
    grad_rel = max(float((grads["unpacked"][k] - grads["packed"][k])
                         .abs().max()) for k in FLOAT_FIELDS) / max(
        float(v.abs().max()) for v in grads["packed"].values())
    log(f"  (a) gradients through one Composite backward, unpacked against "
        f"packed: max |difference| over every field {grad_rel:.3e} of the "
        f"largest gradient")
    if not grad_rel <= 1e-5:
        raise AssertionError("the unpacked route's gradients differ")
    del grads, proj, rgb
    out.update(unpacked_max_abs_err=fwd_err, unpacked_grad_rel=grad_rel)

    # (b) per-stage latency at the bench config and at the 3M config
    for name, scene, pcfg in (
            ("bench", lambda: (g, cam),
             profile_stages.bench_profile_config()),
            ("feasibility", lambda: workloads.feasibility_scene(dev)[:2],
             workloads.feasibility_config())):
        gp, camp = scene()
        prof = profile_stages.profile_stages(gp, camp, pcfg, reps=30)
        del gp
        log(f"  (b) profile_stages {name}: {prof['n']} Gaussians at "
            f"{prof['res'][0]}x{prof['res'][1]}, tile {prof['tile_size']}, "
            f"K={prof['K']} M={prof['M']} bbox {prof['bbox']} two-tier "
            f"{prof['two_tier']}, T={prof['T']} ({prof['timer']}, mean of "
            f"{prof['reps']}; {smi})")
        for stage, ms in prof["stages"].items():
            log(f"    {stage:24s} {ms:9.4f} ms")
        log(f"    one profiled train step: {prof['step_ops_total_ms']:.4f} ms "
            f"of {prof['step_ops_time']} time, "
            f"{prof['step_ops_attributed_ms']:.4f} ms of it over "
            f"{prof['step_ops_launches']:.0f} launches by where the "
            f"operation that launched it ran:")
        for where, op, n_launch, ms in prof["step_ops"]:
            log(f"    {ms:9.4f} ms x{n_launch:<5.0f} {op[:28]:28s} {where}")
        log("    by operation: " + ", ".join(
            f"{op} x{n:.0f} {ms:.4f} ms"
            for op, n, ms in prof["step_ops_by_op"][:12]))
        out[f"profile_{name}"] = prof

    # (c) capacity equivalence on the bench scene
    keq = k_equiv.k_equiv(g, cam)
    for r in keq["ks"]:
        extra = ("" if "psnr" not in r else
                 f", {r['psnr']:.2f} dB against K={keq['k_ref']}, max |grad "
                 f"difference| {r['max_grad_diff']:.3e} of scale "
                 f"{r['grad_scale']:.3e}, step {r['step_ms']:.4f} ms, "
                 f"{r['gaussians_per_s']:.1f} Gaussians/s")
        log(f"  (c) k_equiv K={r['K']} (M {keq['M']}): truncated "
            f"{r['truncated']}, overflowed tiles {r['overflowed_tiles']}, "
            f"max tile count {r['max_tile_count']}{extra}")
    out["k_equiv"] = keq
    del g

    # (d) the lossless 1M 512x512 staged config
    g, cam = workloads.staged_scene(dev)
    res = cam.width
    composite_fwd.launches = composite_bwd.launches = 0
    log(f"  (d) staged_lossless ({smi}):")
    stg = staged_lossless.staged_lossless(g, cam,
                                          log=lambda line: log(f"    {line}"))
    torch.cuda.synchronize()
    launches = (composite_fwd.launches, composite_bwd.launches)
    log(f"    launches over the tool's run: fwd {launches[0]} bwd "
        f"{launches[1]}")
    if min(launches) < 1:
        raise AssertionError("the staged run launched no kernel")
    cfgs = stg.pop("configs")
    out.update(staged=stg, staged_launches=launches)
    # both kernels against their plain versions at the staged K two-tier
    cfg_s = cfgs[stg["grad_check"]["staged"]]
    with torch.no_grad():
        geom, feat, counts, st = bin_and_gather_packed(
            project(g, cam, cfg_s), res, res, cfg_s)
        tx = num_tiles(res, res, cfg_s.tile_size)[0]
        kw = dict(tiles_x=tx, cfg=cfg_s, has_dlim=False)
        fwd = composite_fwd(geom, feat, counts, None, **kw)
        torch.cuda.synchronize()
        log(f"    {stg['grad_check']['staged']}: T={geom.shape[0]} K="
            f"{geom.shape[2]}, truncated {int(st.truncated_gaussians)}; "
            f"{nblk_histogram(fwd[2])}")
        f_err = compare_fwd(fwd, composite_fwd_plain(
            geom, feat, counts, None, **kw), "staged K two-tier",
            (geom, counts, None, kw))[0]
        gout = torch.randn(fwd[0].shape, generator=torch.Generator()
                           .manual_seed(14)).to(dev)
        args = (geom, feat, counts, None, gout, *fwd[1:])
        b_err = compare_bwd(composite_bwd(*args, **kw),
                            composite_bwd_plain(*args, **kw),
                            "bwd staged K two-tier")
        f_ms = time_ms(lambda: composite_fwd(geom, feat, counts, None, **kw),
                       reps=100)
        f_plain = time_ms(lambda: composite_fwd_plain(geom, feat, counts,
                                                      None, **kw),
                          reps=2, warmup=1)
        b_ms = time_ms(lambda: composite_bwd(*args, **kw), reps=100)
        b_plain = time_ms(lambda: composite_bwd_plain(*args, **kw), reps=2,
                          warmup=1)
        fb_ms, fb_by, fb_detail, work = fwd_bound(geom, counts, fwd[2], None,
                                                  tx, cfg_s)
        bb_ms, bb_by, bb_detail = bwd_bound(geom, counts, fwd[2], None, tx,
                                            cfg_s, work)
    log(f"    composite_fwd {f_ms:.4f} ms, plain {f_plain:.4f} ms; bound "
        f"{fb_ms:.6f} ms ({fb_detail}), share {fb_ms / f_ms:.4f}; library "
        f"call: none ({smi})")
    log(f"    composite_bwd {b_ms:.4f} ms, plain {b_plain:.4f} ms; bound "
        f"{bb_ms:.6f} ms ({bb_detail}), share {bb_ms / b_ms:.4f}; library "
        f"call: none ({smi})")
    out.update(staged_fwd_ms=f_ms, staged_fwd_plain_ms=f_plain,
               staged_fwd_bound_ms=fb_ms, staged_fwd_bound_by=fb_by,
               staged_fwd_max_abs_err=f_err, staged_bwd_ms=b_ms,
               staged_bwd_plain_ms=b_plain, staged_bwd_bound_ms=bb_ms,
               staged_bwd_bound_by=bb_by, staged_bwd_max_abs_err=b_err)
    del geom, feat, counts, fwd, gout, args
    # the forward at the lossless K: timed and bounded on every tile, held
    # against its plain version on the middle half of the tile rows (their
    # splats' y means moved up by the rows above, so the rows sit at the
    # top of the image the kernel sees)
    cfg_l = cfgs[f"K{stg['sized']['K_lossless']}"]
    with torch.no_grad():
        geom, feat, counts, _ = bin_and_gather_packed(
            project(g, cam, cfg_l), res, res, cfg_l)
        tx, ty = num_tiles(res, res, cfg_l.tile_size)
        kw = dict(tiles_x=tx, cfg=cfg_l, has_dlim=False)
        fwd = composite_fwd(geom, feat, counts, None, **kw)
        torch.cuda.synchronize()
        l_ms = time_ms(lambda: composite_fwd(geom, feat, counts, None, **kw),
                       reps=20)
        lb_ms, lb_by, lb_detail, _ = fwd_bound(geom, counts, fwd[2], None,
                                               tx, cfg_l)
        nblk_l = nblk_histogram(fwd[2])
        r0, r1 = ty // 4, ty - ty // 4
        sub = slice(r0 * tx, r1 * tx)
        geom_h = geom[sub].clone()
        geom_h[:, 1] -= float(r0 * cfg_l.tile_size)
        feat_h, counts_h = feat[sub].contiguous(), counts[sub].contiguous()
        del geom, feat, counts, fwd
        got = composite_fwd(geom_h, feat_h, counts_h, None, **kw)
        torch.cuda.synchronize()
        l_err = compare_fwd(got, composite_fwd_plain(
            geom_h, feat_h, counts_h, None, **kw), "lossless K, half the "
            "tiles", (geom_h, counts_h, None, kw))[0]
        lh_ms = time_ms(lambda: composite_fwd(geom_h, feat_h, counts_h, None,
                                              **kw), reps=20)
        lh_plain = time_ms(lambda: composite_fwd_plain(
            geom_h, feat_h, counts_h, None, **kw), reps=1, warmup=0)
    log(f"    lossless K={cfg_l.tile_capacity}: {nblk_l}; composite_fwd "
        f"{l_ms:.4f} ms; bound {lb_ms:.6f} ms ({lb_detail}), share "
        f"{lb_ms / l_ms:.4f}; on tile rows {r0}..{r1 - 1} "
        f"({geom_h.shape[0]} tiles) {lh_ms:.4f} ms, plain {lh_plain:.4f} ms;"
        f" library call: none ({smi})")
    out.update(lossless_K=cfg_l.tile_capacity, lossless_fwd_ms=l_ms,
               lossless_fwd_bound_ms=lb_ms, lossless_fwd_bound_by=lb_by,
               lossless_half_ms=lh_ms, lossless_half_plain_ms=lh_plain,
               lossless_fwd_max_abs_err=l_err)
    log(f"  phase 14 {time.perf_counter() - t14:.1f} s")
    return out


if __name__ == "__main__":
    sys.exit(main())
