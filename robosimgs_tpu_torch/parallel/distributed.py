"""Sharded training steps: DP over cameras x tile-sharded rasterization,
and the Gaussian set sharded over ranks.

A port of robosimgs_tpu/parallel/distributed.py on torch.distributed.
Each rank is a process running what the JAX package's shard_map body
runs, on a ("data", "tile") DeviceMesh (parallel/mesh.py); every
collective goes through parallel/comm.py.

  * make_dp_train_step: the Gaussians are replicated; the 'data' axis
    shards the camera batch, the 'tile' axis the image rows of each
    frame (a principal-point-shifted crop camera projected with the full
    frame's tan_half_fov). The loss is taken on the all-gathered frame
    (SSIM windows crossing strips are exact); the gather's transpose
    sums the identical per-tile-rank cotangents, so gradients take a
    mean over 'tile', then over 'data'.
  * make_gaussian_sharded_train_step: parameters, Adam moments and
    densify statistics live sharded over 'data' (each rank holds its
    slice [r cap/n, (r+1) cap/n) of every capacity-leading tensor). Each
    rank projects its shard and all-gathers the projection as one packed
    tensor ("all_gather"), or streams raw chunks around the ring
    (parallel/ring.py, "ring"); gradients come back reduce-scattered to
    their shard and are summed over 'tile' and scaled by
    1 / (n_shard n_tile).
  * make_sharded_densify_step / make_sharded_compact /
    sharded_pool_target: densify, compaction and pool sizing per shard.

Every rank passes the same global arguments (the whole camera batch and
targets, the one camera and target) and its own shard of a sharded
state; a rank's backward reaches its collectives in one fixed order
(one gather per structure, one backward per camera).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import torch

from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.parallel import comm
from robosimgs_tpu_torch.parallel.mesh import axis_size
from robosimgs_tpu_torch.parallel.ring import (crop_camera_rows,
                                               ring_render_rows)
from robosimgs_tpu_torch.render.project import Projected, project
from robosimgs_tpu_torch.render.reference import composite_reference
from robosimgs_tpu_torch.render.tiled import composite_tiled
from robosimgs_tpu_torch.train.densify import (compact_and_resize,
                                               densify_and_prune,
                                               update_stats)
from robosimgs_tpu_torch.train.losses import photometric_loss, psnr
from robosimgs_tpu_torch.train.optim import (FLOAT_FIELDS, float_params,
                                             make_optimizer,
                                             reset_slots_in_opt_state)
from robosimgs_tpu_torch.train.trainer import (TrainConfig, TrainState,
                                               _sh_mask)


def stack_cameras(cams: List[Camera]) -> Camera:
    """One batched Camera (leading dim B) from cameras of one
    resolution."""
    if len({(c.width, c.height) for c in cams}) != 1:
        raise ValueError("stack_cameras needs one resolution")
    return Camera(**{k: torch.stack([getattr(c, k) for c in cams])
                     for k in ("fx", "fy", "cx", "cy", "c2w")},
                  width=cams[0].width, height=cams[0].height)


def index_camera(cam_batch: Camera, i: int) -> Camera:
    return Camera(**{k: getattr(cam_batch, k)[i]
                     for k in ("fx", "fy", "cx", "cy", "c2w")},
                  width=cam_batch.width, height=cam_batch.height)


def _composite(proj, width, rows, cfg: TrainConfig, bg, impl: str):
    if impl == "reference":
        return composite_reference(proj, width, rows, cfg.render, bg)
    if impl == "tiled":
        return composite_tiled(proj, width, rows, cfg.render, bg)
    raise ValueError(f"unknown impl {impl!r}")


def _background(cfg: TrainConfig, device) -> torch.Tensor:
    return torch.tensor(cfg.background, dtype=torch.float32, device=device)


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, likes) -> list:
    out, i = [], 0
    for t in likes:
        out.append(flat[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return out


def _leaves(params: dict, offset: torch.Tensor) -> list:
    return [params[k] for k in FLOAT_FIELDS] + [offset]


def _step_inputs(g):
    params = {k: getattr(g, k).detach().requires_grad_(True)
              for k in FLOAT_FIELDS}
    offset = torch.zeros((g.capacity, 2), device=g.device,
                         requires_grad=True)
    return params, offset


def _apply_update(state: TrainState, optimizer, p_grads: dict, dstate):
    """(state after one Adam update and the new densify statistics, the
    new Gaussians)."""
    g = state.gaussians
    new_params, opt_state = optimizer.step(float_params(g), p_grads,
                                           state.opt_state)
    new_g = g.replace(**new_params)
    return dataclasses.replace(state, gaussians=new_g, opt_state=opt_state,
                               densify_state=dstate,
                               step=state.step + 1), new_g


def make_dp_train_step(cfg: TrainConfig, mesh, impl: str = "tiled",
                       return_grads: bool = False) -> Callable:
    """train_step(state, cam_batch, targets) -> (state, metrics).

    state replicated on every rank; cam_batch a batched Camera of B
    cameras (stack_cameras), targets (B, H, W, 3), the same on every
    rank; B divisible by the 'data' size, H by the 'tile' size. Data
    rank d trains on cameras [d B/n_data, (d+1) B/n_data). loss and psnr
    are the batch means (each rank sums l / b_local over its cameras,
    then a mean over 'tile' and over 'data'); with return_grads the
    metrics hold the reduced gradients."""
    optimizer = make_optimizer(cfg.optim, cfg.scene_extent)
    n_data, n_tile = axis_size(mesh, "data"), axis_size(mesh, "tile")
    data_g, tile_g = mesh.get_group("data"), mesh.get_group("tile")
    d_rank, t_rank = mesh.get_local_rank("data"), mesh.get_local_rank("tile")

    def train_step(state: TrainState, cam_batch: Camera,
                   targets: torch.Tensor):
        B, H = targets.shape[0], cam_batch.height
        if B % n_data or H % n_tile:
            raise ValueError(f"batch {B} / height {H} do not split over "
                             f"the mesh ({n_data}, {n_tile})")
        b_local, rows = B // n_data, H // n_tile
        g = state.gaussians
        dev = g.device
        mask = _sh_mask(state.step, cfg.sh_warmup_every, g.sh_rest.shape[1],
                        dev)
        bg = _background(cfg, dev)
        params, offset = _step_inputs(g)
        inputs = _leaves(params, offset)
        grads = None
        loss = torch.zeros((), device=dev)
        psnr_v = torch.zeros((), device=dev)
        radii = torch.zeros((g.capacity,), device=dev)
        valid = torch.zeros((g.capacity,), dtype=torch.bool, device=dev)
        for i in range(b_local):
            j = d_rank * b_local + i
            cam = index_camera(cam_batch, j).to(dev)
            target = targets[j].to(dev)
            p = g.replace(**{**params, "sh_rest": params["sh_rest"] * mask})
            crop = crop_camera_rows(cam, t_rank * rows, rows)
            proj = project(p, crop, cfg.render, means2d_offset=offset,
                           tan_half_fov=cam.tan_half_fov)
            out = _composite(proj, crop.width, rows, cfg, bg, impl)
            rgb_full = comm.all_gather(out["rgb"], tile_g)
            l_i = photometric_loss(rgb_full, target, cfg.ssim_lambda)
            # one backward a camera: the gradient of sum_i l_i / b_local
            g_i = torch.autograd.grad(l_i / b_local, inputs)
            grads = list(g_i) if grads is None else [
                a + b for a, b in zip(grads, g_i)]
            with torch.no_grad():
                loss = loss + l_i / b_local
                psnr_v = psnr_v + psnr(rgb_full, target) / b_local
                radii = torch.maximum(radii, proj.radii)
                valid = valid | proj.valid

        with torch.no_grad():
            # a mean over 'tile', not a sum: every tile rank takes the
            # loss of the gathered frame, and the gather's transpose
            # already summed their identical cotangents; cameras are
            # averaged over 'data'
            flat = comm.pmean(comm.pmean(_flat(grads), tile_g), data_g)
            grads = _unflat(flat, inputs)
            rv = torch.stack([radii, valid.to(radii.dtype)])
            rv = comm.pmax(comm.pmax(rv, tile_g), data_g)
            lp = comm.pmean(comm.pmean(torch.stack([loss, psnr_v]), tile_g),
                            data_g)
            p_grads = dict(zip(FLOAT_FIELDS, grads[:-1]))
            dstate = update_stats(state.densify_state, grads[-1], rv[0],
                                  rv[1] > 0, cam_batch.width, H)
            new_state, new_g = _apply_update(state, optimizer, p_grads,
                                             dstate)
            metrics = {"loss": lp[0], "psnr": lp[1],
                       "n_alive": new_g.num_alive}
            if return_grads:
                metrics["grads"] = p_grads
        return new_state, metrics

    return train_step


# -- gaussian-sharded training (the TP / ZeRO analog) ----------------------


def _gather_projected(proj: Projected, group) -> Projected:
    """The whole set's projection from every shard's: one packed tensor
    in one differentiable all_gather (a gradient arrives at its shard
    reduce-scattered), where the JAX package gathers each leaf. radii
    go detached: ceil's zero gradient times sqrt's infinite slope at a
    zero eigenvalue would be NaN (JAX's symbolic zeros skip it)."""
    cols = [proj.means2d, proj.conics, proj.depths[:, None],
            proj.radii.detach()[:, None], proj.colors,
            proj.opacities[:, None],
            proj.valid.to(proj.depths.dtype)[:, None]]
    if proj.normals is not None:
        cols.append(proj.normals)
    widths = [c.shape[1] for c in cols]
    parts = torch.split(comm.all_gather(torch.cat(cols, dim=1), group),
                        widths, dim=1)
    return Projected(
        means2d=parts[0], conics=parts[1], depths=parts[2][:, 0],
        radii=parts[3][:, 0], colors=parts[4], opacities=parts[5][:, 0],
        valid=parts[6][:, 0] > 0.5,
        normals=parts[7] if proj.normals is not None else None)


def make_gaussian_sharded_train_step(cfg: TrainConfig, mesh,
                                     impl: str = "tiled",
                                     return_grads: bool = False,
                                     gather: str = "all_gather") -> Callable:
    """train_step(state, camera, target) -> (state, metrics) with the
    Gaussian set sharded over 'data': state is this rank's shard (its
    slice of every capacity-leading tensor, core/convert.py's
    shard_train_state_from_numpy), camera and target the same on every
    rank (one camera a step).

    gather "all_gather": project the local shard and all-gather the
    compact projection; "ring": never hold the whole set, rotate raw
    chunks around the 'data' ring (parallel/ring.py; needs the tiled
    impl). Gradient bookkeeping: the loss is taken on every rank; the
    'data' gather's transpose sums n_shard identical cotangents and the
    'tile' one n_tile, so the shard gradient is the sum over 'tile'
    times 1 / (n_shard n_tile). metrics: loss and psnr (means over
    'tile' and 'data'), n_alive (summed over shards), and with
    return_grads the local shard's gradients."""
    if gather not in ("all_gather", "ring"):
        raise ValueError(f"unknown gather {gather!r}")
    if gather == "ring" and impl != "tiled":
        raise ValueError("gather='ring' requires impl='tiled'")
    optimizer = make_optimizer(cfg.optim, cfg.scene_extent)
    n_shard, n_tile = axis_size(mesh, "data"), axis_size(mesh, "tile")
    data_g, tile_g = mesh.get_group("data"), mesh.get_group("tile")
    t_rank = mesh.get_local_rank("tile")
    scale = 1.0 / (n_shard * n_tile)

    def train_step(state: TrainState, camera: Camera, target: torch.Tensor):
        H = camera.height
        if H % n_tile:
            raise ValueError(f"height {H} does not split over {n_tile} "
                             "tile ranks")
        rows = H // n_tile
        g = state.gaussians                       # the local shard
        dev = g.device
        camera, target = camera.to(dev), target.to(dev)
        mask = _sh_mask(state.step, cfg.sh_warmup_every, g.sh_rest.shape[1],
                        dev)
        bg = _background(cfg, dev)
        params, offset = _step_inputs(g)
        masked = {**params, "sh_rest": params["sh_rest"] * mask}
        if gather == "ring":
            out = ring_render_rows(masked, g.alive, offset, camera, t_rank,
                                   n_tile, cfg.render, bg, data_g)
            # densify statistics of the local shard ride the ring's hop-0
            # side channel: no extra projection
            radii, valid = out["radii"], out["valid"]
        else:
            crop = crop_camera_rows(camera, t_rank * rows, rows)
            proj_local = project(g.replace(**masked), crop, cfg.render,
                                 means2d_offset=offset,
                                 tan_half_fov=camera.tan_half_fov)
            out = _composite(_gather_projected(proj_local, data_g),
                             crop.width, rows, cfg, bg, impl)
            radii, valid = proj_local.radii.detach(), proj_local.valid
        rgb_full = comm.all_gather(out["rgb"], tile_g)
        loss = photometric_loss(rgb_full, target, cfg.ssim_lambda)
        inputs = _leaves(params, offset)
        grads = torch.autograd.grad(loss, inputs)

        with torch.no_grad():
            flat = comm.psum(_flat(grads) * scale, tile_g)
            grads = _unflat(flat, inputs)
            rv = comm.pmax(torch.stack([radii, valid.to(radii.dtype)]),
                           tile_g)
            lp = comm.pmean(comm.pmean(torch.stack(
                [loss.detach(), psnr(rgb_full, target)]), tile_g), data_g)
            p_grads = dict(zip(FLOAT_FIELDS, grads[:-1]))
            dstate = update_stats(state.densify_state, grads[-1], rv[0],
                                  rv[1] > 0, camera.width, H)
            new_state, new_g = _apply_update(state, optimizer, p_grads,
                                             dstate)
            metrics = {"loss": lp[0], "psnr": lp[1],
                       "n_alive": comm.psum(new_g.num_alive, data_g)}
            if return_grads:
                metrics["grads"] = p_grads
        return new_state, metrics

    return train_step


# -- densify / compaction under the gaussian-sharded pool ------------------


def make_sharded_densify_step(cfg: TrainConfig, mesh) -> Callable:
    """densify_step(state, enable_scale_prune=True) -> (state, info).

    Every shard runs the single-device round (train/densify.py) on its
    own slots: the grow / prune decisions are the global controller's
    (per-Gaussian thresholds), slot assignment is shard-local, so a full
    shard saturates even if another has free slots; info ("requested",
    "spawned", "pruned") is summed over shards, so saturation is
    counted, never silent. Spawned slots' Adam moments are zeroed.

    RNG: one seed drawn from the state's generator (which so advances
    alike on every rank), the split draws from a generator seeded by
    (that seed, data rank): independent across shards, the same on the
    tile ranks of a shard."""
    data_g = mesh.get_group("data")
    d_rank = mesh.get_local_rank("data")

    def densify_step(state: TrainState, enable_scale_prune: bool = True):
        with torch.no_grad():
            seed = int(torch.randint(0, 2 ** 31 - 1, (1,),
                                     generator=state.generator))
            draws = torch.Generator().manual_seed(seed * 65536 + d_rank)
            g, dstate, spawn, info = densify_and_prune(
                state.gaussians, state.densify_state, draws, cfg.densify,
                cfg.scene_extent, enable_scale_prune=enable_scale_prune,
                return_info=True)
            opt_state = reset_slots_in_opt_state(state.opt_state, spawn)
            names = ("requested", "spawned", "pruned")
            total = comm.psum(torch.stack([info[k] for k in names]), data_g)
        return dataclasses.replace(state, gaussians=g, opt_state=opt_state,
                                   densify_state=dstate), \
            dict(zip(names, total))

    return densify_step


def make_sharded_compact(mesh) -> Callable:
    """compact(state, new_local_capacity) -> state: every shard compacts
    its live Gaussians to a prefix and slices / pads to
    new_local_capacity slots (train/densify.py::compact_and_resize:
    moments and statistics move with their slots), so the pool stays
    evenly sharded with no traffic between ranks. Pick the capacity with
    sharded_pool_target so that no shard truncates."""
    del mesh          # every shard compacts alone

    def compact(state: TrainState, new_local_capacity: int) -> TrainState:
        with torch.no_grad():
            g, opt, d = compact_and_resize(state.gaussians, state.opt_state,
                                           state.densify_state,
                                           int(new_local_capacity))
        return dataclasses.replace(state, gaussians=g, opt_state=opt,
                                   densify_state=d)

    return compact


def sharded_pool_target(state: TrainState, mesh, headroom: float,
                        bucket: int, local_max: int) -> int:
    """Per-shard capacity for the next compaction: the largest shard's
    alive count (one all_reduce MAX over 'data') with spawn headroom,
    rounded up to `bucket`, clamped to [bucket, local_max]. Waits for the
    device (densify boundaries only)."""
    alive = comm.pmax(state.gaussians.num_alive, mesh.get_group("data"))
    want = int(int(alive) * (1.0 + headroom)) + 1
    want = -(-want // bucket) * bucket
    return max(bucket, min(want, local_max))
