"""The ring-streamed Gaussian-sharded train step at 512k and 1M
Gaussians over 8 ranks, against the all_gather step, and the render
path's memory law across world sizes.

    python -m robosimgs_tpu_torch.tools.ring_at_scale
        [--n 524288 1048576] [--world 8] [--law-world 2 4 8]
        [--law-n 131072 1048576] [--device cuda] [--out result.json]

A port of the JAX package's scripts/ring_at_scale.py. Its 8 virtual
devices are 8 ranks over gloo (tools/dist_run.py::run_ranks), each on
the card (every rank on cuda:0, the ring's send/recv staged through
pinned host memory by parallel/comm.py) or, with --device cpu, on the
CPU. One spawn runs every configuration of a world size, so start-up is
paid once per world.

(a) `run_config`, at each --n and both gathers: the script's config (64x64
from look_at([4, 0.5, 1.2] -> 0, 60 deg), K 256, M 12, SH 2, extent 1.5,
a zero target), the state sharded along the Gaussian axis before the
step (each rank builds the draw, torch.Generator seed 1, and keeps its
slice), two steps of make_gaussian_sharded_train_step: loss0, loss1,
the first and the steady step's seconds, the kernels' launches, and on
the card the step's own peak device bytes (peak memory statistics
reset after the state is placed) beside the bytes the state holds;
ru_maxrss as the JAX record has it (it includes the CUDA context and
the spawn).

(b) `render_law`: the render path's peak device bytes above what the
rank held before the call, for one forward + gradient of
parallel/ring.py::ring_render_rows and of the all_gather path (project
the shard, gather the projected set, composite_tiled), at each
--law-world and --law-n. The JAX script reads XLA's compile-time temp
bytes, which torch has no counterpart of: the card's bytes are this
port's law (None on the CPU).

Rank 0 of the --world spawn also returns the ring's merged blocks at the
largest --n (`blocks`, for a caller to hold the kernels against their
plain versions). Prints one JSON line with the JAX record's keys
(`devices`, `executed_steps`, a `render_path_*` list) and the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import resource
import sys
import time

import torch

from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.core.types import Gaussians
from robosimgs_tpu_torch.parallel.distributed import (
    _gather_projected, make_gaussian_sharded_train_step)
from robosimgs_tpu_torch.parallel.ring import (crop_camera_rows,
                                               ring_bin_gather,
                                               ring_render_rows)
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.project import project
from robosimgs_tpu_torch.render.tiled import composite_tiled
from robosimgs_tpu_torch.tools import dist_run, workloads
from robosimgs_tpu_torch.tools.k_equiv import device_name
from robosimgs_tpu_torch.train.densify import DensifyState
from robosimgs_tpu_torch.train.optim import float_params, make_optimizer
from robosimgs_tpu_torch.train.trainer import TrainConfig, TrainState

N_DEV = 8
NS = (524_288, 1_048_576)
GATHERS = ("ring", "all_gather")
LAW_WORLDS = (2, 4, 8)
LAW_NS = (131_072, 1_048_576)
RES = 64
STEPS = 2


def train_config() -> TrainConfig:
    return TrainConfig(render=RenderConfig(tile_capacity=256,
                                           max_tiles_per_gaussian=12),
                       scene_extent=1.0, impl="tiled")


def camera(device) -> Camera:
    return Camera.look_at([4.0, 0.5, 1.2], [0, 0, 0], [0, 0, 1], 60.0, RES,
                          RES, device=device)


def draw(n: int) -> Gaussians:
    """The script's scene: n random Gaussians, SH 2, extent 1.5 (the CPU
    generator seeded 1)."""
    return Gaussians.random(torch.Generator().manual_seed(1), n, sh_degree=2,
                            extent=1.5, device="cpu")


def shard(g: Gaussians, world: int, rank: int, device) -> Gaussians:
    """Slots [rank n / world, (rank + 1) n / world) of every field."""
    local = g.capacity // world
    sl = slice(rank * local, (rank + 1) * local)
    return g.replace(**{f.name: getattr(g, f.name)[sl].to(device)
                        for f in dataclasses.fields(g)})


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def run_config(rank, world, device, mesh, n: int, gather: str,
               g: Gaussians | None = None) -> dict:
    """(a) of the module docstring on this rank: two steps at n
    Gaussians (g: the whole draw, default `draw(n)`)."""
    dev = torch.device(device)
    cfg = train_config()
    local = shard(g if g is not None else draw(n), world, rank, dev)
    optimizer = make_optimizer(cfg.optim, cfg.scene_extent)
    state = TrainState(gaussians=local,
                       opt_state=optimizer.init(float_params(local)),
                       densify_state=DensifyState.zero(local.capacity,
                                                       device=dev),
                       step=0, generator=torch.Generator().manual_seed(0))
    cam, target = camera(dev), torch.zeros((RES, RES, 3), device=dev)
    step = make_gaussian_sharded_train_step(cfg, mesh, impl="tiled",
                                            gather=gather)
    _sync(dev)
    base_rss = _rss_mb()
    if dev.type == "cuda":
        base_bytes = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    losses, secs = [], []
    with dist_run._Tally() as tally:
        for _ in range(STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, cam, target)
            losses.append(float(metrics["loss"]))
            _sync(dev)
            secs.append(time.perf_counter() - t0)
    peak_rss = _rss_mb()
    out = {"n": n, "gather": gather, "world": world, "rank": rank,
           "loss0": losses[0], "loss1": losses[1], "first_s": secs[0],
           "steady_s": secs[1], "base_rss_mb": base_rss,
           "peak_rss_mb": peak_rss, "step_rss_mb": peak_rss - base_rss,
           "launches": list(tally.out["launches"]),
           "comm_calls": tally.out["comm_calls"],
           "base_bytes": None, "peak_bytes": None, "step_bytes": None}
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        out.update(base_bytes=base_bytes, peak_bytes=peak,
                   step_bytes=peak - base_bytes)
    return out


def _render_grad(params, fn):
    """Sum of fn(params)'s rgb and its gradient (freed)."""
    value = fn(params)["rgb"].sum()
    torch.autograd.grad(value, list(params.values()))
    return float(value.detach())


def render_law(rank, world, device, mesh, n: int,
               g: Gaussians | None = None) -> dict:
    """(b) of the module docstring on this rank at n Gaussians: each
    render path's rgb sum and, on the card, its peak device bytes above
    what the rank held before the call."""
    dev = torch.device(device)
    cfg = train_config().render
    group = mesh.get_group("data")
    local = shard(g if g is not None else draw(n), world, rank, dev)
    params = {k: v.requires_grad_() for k, v in float_params(local).items()}
    off = torch.zeros((local.capacity, 2), device=dev)
    cam, bg = camera(dev), torch.zeros(3, device=dev)

    def ring(p):
        return ring_render_rows(p, local.alive, off, cam, 0, 1, cfg, bg, group)

    def all_gather(p):
        crop = crop_camera_rows(cam, 0, RES)
        proj = project(Gaussians(**p, alive=local.alive), crop, cfg,
                       means2d_offset=off, tan_half_fov=cam.tan_half_fov)
        return composite_tiled(_gather_projected(proj, group), RES, RES, cfg,
                               bg)

    row = {"devices": world, "n": n, "rank": rank}
    for name, fn in (("ring", ring), ("all_gather", all_gather)):
        _sync(dev)
        if dev.type == "cuda":
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        row[f"{name}_value"] = _render_grad(params, fn)
        _sync(dev)
        row[f"{name}_peak_bytes"] = (
            torch.cuda.max_memory_allocated(dev) - before
            if dev.type == "cuda" else None)
    return row


def run_world(rank, world, device, configs, law_ns, blocks_n=None,
              gaussians=None) -> dict:
    """Every configuration of one world on this rank, in one spawn:
    run_config for each (n, gather) of configs, render_law for each n of
    law_ns, and (rank 0, blocks_n given) the ring's merged blocks at
    blocks_n. gaussians: {n: whole draw} to use in place of draw(n)."""
    gaussians = gaussians or {}
    mesh = dist_run._mesh((world, 1), device)
    out = {"configs": [run_config(rank, world, device, mesh, n, gather,
                                  gaussians.get(n))
                       for n, gather in configs],
           "law": [render_law(rank, world, device, mesh, n, gaussians.get(n))
                   for n in law_ns]}
    if blocks_n is not None:
        dev = torch.device(device)
        cfg = train_config().render
        g = gaussians.get(blocks_n)
        local = shard(g if g is not None else draw(blocks_n), world, rank,
                      dev)
        cam = camera(dev)
        with torch.no_grad():
            geom, feat, counts, stats, _, _ = ring_bin_gather(
                float_params(local), local.alive,
                torch.zeros((local.capacity, 2), device=dev),
                (cam, cam.tan_half_fov), RES, RES, cfg,
                mesh.get_group("data"))
        if rank == 0:
            out["blocks"] = {"n": blocks_n, "geom": geom, "feat": feat,
                             "counts": counts, "stats": stats}
    return out


def ring_at_scale(device: str = "cuda", ns=NS, world: int = N_DEV,
                  law_worlds=LAW_WORLDS, law_ns=LAW_NS,
                  gaussians=None, log=None) -> dict:
    """(a) at `world` for every n of ns and gather, and (b) at every world
    of law_worlds: one spawn per world. Returns the JSON's dict, with
    "ranks" (every rank's rows) and "blocks" (rank 0's merged ring
    blocks at max(ns), numpy; not serialised by the CLI). A rank that
    raises fails the run."""
    log = log or (lambda line: None)
    if torch.device(device).type == "cuda":
        from robosimgs_tpu_torch.render import _build
        _build.build_all(["composite_fwd", "composite_bwd"])
    steps, law, ranks, blocks = [], [], {}, None
    for w in sorted(set(law_worlds) | {world}):
        configs = ([(n, gather) for n in ns for gather in GATHERS]
                   if w == world else [])
        t0 = time.perf_counter()
        got = dist_run.run_ranks(
            run_world, w, backend="gloo", device=device,
            args=(configs, law_ns if w in law_worlds else [],
                  max(ns) if w == world else None, gaussians))
        ranks[w] = got
        log(f"world {w}: {len(configs)} configurations, "
            f"{len(got[0]['law'])} render-law rows in "
            f"{time.perf_counter() - t0:.1f} s")
        for i, row in enumerate(got[0]["configs"]):
            per_rank = [r["configs"][i] for r in got]
            row = {k: row[k] for k in ("n", "gather", "loss0", "loss1",
                                       "first_s", "steady_s")}
            for key in ("base_bytes", "peak_bytes", "step_bytes",
                        "base_rss_mb", "peak_rss_mb", "step_rss_mb"):
                row[key] = [r[key] for r in per_rank]
            row["launches"] = [r["launches"] for r in per_rank]
            steps.append(row)
            log(json.dumps(row))
        for i, row in enumerate(got[0]["law"]):
            row = {k: row[k] for k in ("devices", "n", "ring_value",
                                       "all_gather_value")}
            for name in ("ring", "all_gather"):
                row[f"{name}_peak_bytes"] = [
                    r["law"][i][f"{name}_peak_bytes"] for r in got]
            law.append(row)
            log(json.dumps(row))
        if "blocks" in got[0]:
            blocks = got[0]["blocks"]
    return {"devices": world, "executed_steps": steps,
            "render_path_peak_bytes_per_rank": law,
            "device": device_name(device),
            "note": ("executed_steps: two steps a configuration on "
                     f"{world} gloo ranks, each rank's peak device bytes "
                     "of the step (peak statistics reset after the state "
                     "is placed) and ru_maxrss (CUDA context and spawn "
                     "included). render_path_peak_bytes_per_rank: one "
                     "forward + gradient of each render path, bytes above "
                     "what the rank held before the call."),
            "ranks": ranks, "blocks": blocks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=list(NS))
    ap.add_argument("--world", type=int, default=N_DEV)
    ap.add_argument("--law-world", type=int, nargs="*",
                    default=list(LAW_WORLDS))
    ap.add_argument("--law-n", type=int, nargs="*", default=list(LAW_NS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if workloads.open_device(args.device, "ring_at_scale") is None:
        return 1
    res = ring_at_scale(args.device, args.n, args.world, args.law_world,
                        args.law_n, log=lambda s: print(s, flush=True))
    for key in ("ranks", "blocks"):
        res.pop(key)
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
