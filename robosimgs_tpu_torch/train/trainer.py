"""3DGS training loop (the role of `ns-train splatfacto`).

A port of robosimgs_tpu/train/trainer.py, in eager torch: one train
step (render -> L1+SSIM -> backward -> per-group Adam) with a
screen-space gradient probe feeding the densification statistics; a
densification round every `densify_interval` steps; periodic opacity
reset; SH band warm-up by masking the coefficients inside the loss; an
alive-prefix pool resize at densify boundaries; torch.save checkpoints
for preemption-safe resume.

On CUDA tensors the tiled path composites through the hand-written
forward and backward kernels (render/kernels.py), one launch of each
per step; on CPU tensors through their plain torch versions.

Per-frame color correction, as in the JAX package: an exposure affine
(TrainConfig.exposure) and a bilateral grid (TrainConfig.bilateral_grid,
train/bilagrid.py), each indexed by the step's frame, optimized by its
own Adam group, applied to the rendered image inside the loss (training
PSNR is post-correction; evaluation stays raw). fused_steps > 1 runs
chunks of F steps per call (train/graphed.py): a Python loop on the CPU,
one CUDA graph of the step replayed F times on the card.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.core.types import Gaussians
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.project import project
from robosimgs_tpu_torch.render.rasterize import rasterize
from robosimgs_tpu_torch.render.reference import composite_reference
from robosimgs_tpu_torch.render.tiled import composite_tiled
from robosimgs_tpu_torch.train.bilagrid import (apply_bilagrid,
                                                identity_bilagrid)
from robosimgs_tpu_torch.train.bilagrid import tv_loss as bilagrid_tv_loss
from robosimgs_tpu_torch.train.data import Frame
from robosimgs_tpu_torch.train.densify import (DensifyConfig, DensifyState,
                                               compact_and_resize,
                                               densify_and_prune,
                                               reset_opacities, update_stats)
from robosimgs_tpu_torch.train.graphed import (FusedSteps, select,
                                               stack_frames)
from robosimgs_tpu_torch.train.losses import (maximum, normals_from_depth,
                                              photometric_loss, psnr, ssim)
from robosimgs_tpu_torch.train.optim import (FLOAT_FIELDS, AdamGroup,
                                             OptimConfig, OptState,
                                             float_params, make_optimizer,
                                             reset_slots_in_opt_state)
from robosimgs_tpu_torch.utils.profiling import span


def _zero_opacity_moments(opt_state: OptState) -> OptState:
    """Zero the opacity group's whole Adam state after an opacity reset
    (official 3DGS resets the optimizer state there too — stale momentum
    would instantly undo the clamp). As in the JAX package this zeroes
    the group's count as well, so its bias correction restarts."""
    st = opt_state["logit_opacities"]
    zeroed = AdamGroup(**{f.name: None if getattr(st, f.name) is None
                          else torch.zeros_like(getattr(st, f.name))
                          for f in dataclasses.fields(st)})
    return {**opt_state, "logit_opacities": zeroed}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's TrainConfig, field for field (see its
    comments)."""

    iterations: int = 7000
    ssim_lambda: float = 0.2
    sh_warmup_every: int = 1000
    scene_extent: float = 1.0
    render: RenderConfig = RenderConfig()
    optim: OptimConfig = OptimConfig()
    densify: DensifyConfig = DensifyConfig()
    densify_from: int = 500
    densify_until: int = 15_000
    densify_interval: int = 100
    opacity_reset_interval: int = 3000
    impl: str = "auto"          # "tiled" for CUDA tensors, else "reference"
    background: tuple = (0.0, 0.0, 0.0)
    log_every: int = 100
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 2000
    # dynamic pool: at densify boundaries the pool is compacted and
    # resized to round_up(alive * (1 + pool_headroom), pool_bucket),
    # capped at the initially allocated capacity
    dynamic_pool: bool = True
    pool_bucket: int = 8192
    pool_headroom: float = 1.0
    # scale regularizer: penalizes needle gaussians whose max/min scale
    # ratio exceeds scale_reg_max_ratio (splatfacto use_scale_regularization)
    scale_reg_lambda: float = 0.0
    scale_reg_max_ratio: float = 10.0
    exposure: bool = False
    exposure_lr: float = 1.0e-3
    bilateral_grid: bool = False
    bilagrid_shape: tuple = (8, 8, 4)
    bilagrid_lr: float = 2.0e-3
    bilagrid_tv_lambda: float = 10.0
    # depth supervision: L1 between the alpha-normalized splat depth and
    # a metric target depth on pixels where the target is valid and the
    # splats cover the pixel
    depth_lambda: float = 0.0
    depth_alpha_gate: float = 0.25
    # normal-consistency regularizer (2DGS-style), tiled impl only
    normal_lambda: float = 0.0
    normal_alpha_gate: float = 0.5
    # F train steps per call (0/1 = one): chunks never cross a densify,
    # pool resize, opacity reset or checkpoint, so results are step for
    # step the unfused loop's; needs one frame resolution and
    # device-resident targets (ignored in host-streaming mode)
    fused_steps: int = 0
    # target residency: None = host-resident when the targets exceed
    # host_data_threshold bytes, else all uploaded once. Host-resident
    # targets are uploaded one step ahead from pinned memory.
    host_data: Optional[bool] = None
    host_data_threshold: int = 1 << 30


@dataclasses.dataclass
class TrainState:
    gaussians: Gaussians
    opt_state: OptState
    densify_state: DensifyState
    # an int; inside the graphed steps a 0-d int64 device tensor
    step: int
    # the densification split draws (a CPU generator: same draws on any
    # device); the JAX package carries a PRNG key here
    generator: torch.Generator
    # (n_frames, 3, 4) per-frame affine color correction, or None when
    # TrainConfig.exposure is off
    exposure: Optional[torch.Tensor] = None
    # (n_frames, gh, gw, gl, 12) per-frame bilateral grids, or None when
    # TrainConfig.bilateral_grid is off
    bilagrid: Optional[torch.Tensor] = None


def identity_exposure(n_frames: int, device="cuda") -> torch.Tensor:
    """Identity 3x4 color affines for every frame."""
    e = torch.cat([torch.eye(3), torch.zeros((3, 1))], dim=1)
    return e[None].repeat(n_frames, 1, 1).to(device)


def _sh_mask(step, warmup_every: int, n_rest: int, device) -> torch.Tensor:
    """(n_rest, 1) per-coefficient mask: band b activates at step
    b*warmup. step: an int or a 0-d device tensor. Rest coefficient k
    (0-based) is of band floor(sqrt(k + 1)) (1, 1, 1, 2 x 5, 3 x 7),
    made on the device: no host copy, so a CUDA graph can capture it."""
    bands = torch.arange(1, n_rest + 1, device=device).to(torch.float32)
    bands = torch.floor(torch.sqrt(bands))
    return (bands <= step // warmup_every).to(torch.float32)[:, None]


def _render_for_training(g: Gaussians, camera: Camera, cfg: TrainConfig,
                         offset: torch.Tensor, impl: str, bg: torch.Tensor,
                         abs_probe: Optional[torch.Tensor] = None):
    proj = project(g, camera, cfg.render, means2d_offset=offset,
                   abs_probe=abs_probe)
    if impl == "reference":
        out = composite_reference(proj, camera.width, camera.height,
                                  cfg.render, bg)
        out["overflow"] = torch.zeros((), dtype=torch.int64, device=g.device)
    elif impl == "tiled":
        out = composite_tiled(proj, camera.width, camera.height, cfg.render,
                              bg, return_stats=True)
        # truncation silently degrades quality AND gradients — surface it
        out["overflow"] = (out["stats"].overflowed_tiles
                           + out["stats"].truncated_gaussians)
    else:
        raise ValueError(f"unknown impl {impl!r}")
    return out, proj


def _optimizer(cfg: TrainConfig):
    return make_optimizer(
        cfg.optim, cfg.scene_extent,
        exposure_lr=cfg.exposure_lr if cfg.exposure else None,
        bilagrid_lr=cfg.bilagrid_lr if cfg.bilateral_grid else None)


def make_train_step(cfg: TrainConfig, impl: str) -> Callable:
    """train_step(state, camera, target, frame_idx=0, target_depth=None)
    -> (new state, metrics); metrics are 0-d tensors (read them only
    where the host needs them: each read waits for the device).
    frame_idx (an int, or a (1,) int64 device tensor) picks the frame's
    exposure affine and bilateral grid."""
    if cfg.render.absgrad and impl == "reference":
        raise ValueError("absgrad needs the tiled impl (the reference "
                         "compositor's autograd cannot observe per-pixel "
                         "absolute gradients)")
    if cfg.normal_lambda > 0.0:
        if impl == "reference":
            raise ValueError("normal_lambda needs the tiled impl (only it "
                             "renders the splat-normal map)")
        if not cfg.render.render_normals:
            cfg = dataclasses.replace(
                cfg, render=dataclasses.replace(cfg.render,
                                                render_normals=True))
    optimizer = _optimizer(cfg)
    absgrad = cfg.render.absgrad

    @span("train.step")
    def train_step(state: TrainState, camera: Camera, target: torch.Tensor,
                   frame_idx=0, target_depth: Optional[torch.Tensor] = None):
        g = state.gaussians
        dev = g.device
        # made on the device: no host copy, so a CUDA graph can capture it
        bg = torch.stack([torch.full((), c, device=dev)
                          for c in cfg.background])
        mask = _sh_mask(state.step, cfg.sh_warmup_every, g.sh_rest.shape[1],
                        dev)
        params = {k: getattr(g, k).detach().requires_grad_(True)
                  for k in FLOAT_FIELDS}
        if cfg.exposure:
            params["exposure"] = state.exposure.detach().requires_grad_(True)
        if cfg.bilateral_grid:
            params["bilagrid"] = state.bilagrid.detach().requires_grad_(True)
        offset = torch.zeros((g.capacity, 2), device=dev, requires_grad=True)
        absp = (torch.zeros((g.capacity, 2), device=dev, requires_grad=True)
                if absgrad else None)
        # masked coefficients get zero gradient; Adam still moves them
        # by their momentum, as in the JAX package
        p = g.replace(**{**{k: params[k] for k in FLOAT_FIELDS},
                         "sh_rest": params["sh_rest"] * mask})
        out, proj = _render_for_training(p, camera, cfg, offset, impl, bg,
                                         abs_probe=absp)
        rgb = out["rgb"]
        if cfg.exposure:
            e = select(params["exposure"], frame_idx)          # (3, 4)
            rgb = maximum(rgb @ e[:, :3].T + e[:, 3], 0.0)
        if cfg.bilateral_grid:
            rgb = apply_bilagrid(select(params["bilagrid"], frame_idx), rgb)
        loss = photometric_loss(rgb, target, cfg.ssim_lambda)
        if cfg.bilateral_grid:
            loss = loss + cfg.bilagrid_tv_lambda * bilagrid_tv_loss(
                params["bilagrid"])
        if cfg.depth_lambda > 0.0:
            if target_depth is None:
                raise ValueError("depth_lambda > 0 needs per-frame target "
                                 "depth (Frame.depth or transforms.json "
                                 "depth_file_path)")
            a = out["alpha"]
            d = out["depth"] / torch.clamp_min(a, 1e-6)
            dv = (target_depth > 0.0) & (a.detach() > cfg.depth_alpha_gate)
            n_dv = torch.clamp_min(dv.sum(), 1)
            loss = loss + cfg.depth_lambda * torch.where(
                dv, torch.abs(d - target_depth), 0.0).sum() / n_dv
        if cfg.normal_lambda > 0.0:
            a = out["alpha"]
            d = out["depth"] / torch.clamp_min(a, 1e-6)
            nd, nd_valid = normals_from_depth(d, camera.fx, camera.fy,
                                              camera.cx, camera.cy)
            # erode the alpha gate by the central-difference stencil: a
            # covered pixel beside an uncovered one reads a garbage depth
            ag = a.detach() > cfg.normal_alpha_gate
            gate = nd_valid & ag
            for ax in (0, 1):
                for sh in (1, -1):
                    gate = gate & torch.roll(ag, sh, dims=ax)
            n_g = torch.clamp_min(gate.sum(), 1)
            dots = torch.sum(out["normal"] * nd, -1)
            loss = loss + cfg.normal_lambda * torch.where(
                gate, 1.0 - dots, 0.0).sum() / n_g
        if cfg.scale_reg_lambda > 0.0:
            ls = params["log_scales"]
            ratio = torch.exp(torch.amax(ls, -1) - torch.amin(ls, -1))
            pen = torch.clamp_min(ratio, cfg.scale_reg_max_ratio) \
                - cfg.scale_reg_max_ratio
            n_alive = torch.clamp_min(g.alive.sum(), 1)
            loss = loss + cfg.scale_reg_lambda * torch.where(
                g.alive, pen, 0.0).sum() / n_alive

        names = list(params)
        inputs = [params[k] for k in names] + [offset]
        if absgrad:
            inputs.append(absp)
        with span("train.backward"):
            grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if gr is None else gr
                 for x, gr in zip(inputs, grads)]
        p_grads = dict(zip(names, grads))
        # densification signal: absgrad (per-pixel |grad| sums, no sign
        # cancellation) when enabled, else the signed screen gradient
        densify_grad = grads[-1] if absgrad else grads[len(names)]
        with torch.no_grad(), span("train.optim"):
            dstate = update_stats(state.densify_state, densify_grad,
                                  proj.radii.detach(), proj.valid,
                                  camera.width, camera.height)
            current = {**float_params(g),
                       **{k: getattr(state, k) for k in names
                          if k not in FLOAT_FIELDS}}
            new_params, opt_state = optimizer.step(current, p_grads,
                                                   state.opt_state)
            metrics = {"loss": loss.detach(), "psnr": psnr(rgb.detach(), target),
                       "n_alive": g.num_alive, "overflow": out["overflow"]}
        return TrainState(
            gaussians=g.replace(**{k: new_params[k] for k in FLOAT_FIELDS}),
            opt_state=opt_state, densify_state=dstate, step=state.step + 1,
            generator=state.generator,
            exposure=new_params.get("exposure", state.exposure),
            bilagrid=new_params.get("bilagrid", state.bilagrid)), metrics

    return train_step


def make_fused_train_steps(cfg: TrainConfig, impl: str) -> FusedSteps:
    """F train steps per call over a FrameStack (step s trains on frame
    s % n): fused(state, frames, F) -> (state, metrics stacked (F,)).
    The JAX package's lax.scan; here a loop on the CPU and a CUDA graph
    of the step on the card (train/graphed.py)."""
    return FusedSteps(make_train_step(cfg, impl))


def make_densify_step(cfg: TrainConfig) -> Callable:
    def densify_step(state: TrainState, enable_scale_prune: bool = True):
        with torch.no_grad():
            g, dstate, spawn = densify_and_prune(
                state.gaussians, state.densify_state, state.generator,
                cfg.densify, cfg.scene_extent,
                enable_scale_prune=enable_scale_prune)
            opt_state = reset_slots_in_opt_state(state.opt_state, spawn)
        return dataclasses.replace(state, gaussians=g, opt_state=opt_state,
                                   densify_state=dstate)

    return densify_step


class Trainer:
    """Trains `gaussians` on `frames` on the gaussians' device."""

    def __init__(self, cfg: TrainConfig, gaussians: Gaussians,
                 frames: List[Frame], eval_frames: Optional[List[Frame]] = None):
        self.cfg = cfg
        self.frames = frames
        self.eval_frames = eval_frames or []
        impl = cfg.impl
        if impl == "auto":
            impl = "tiled" if gaussians.device.type == "cuda" else "reference"
        self.impl = impl
        dev = gaussians.device
        # own our tensors: the caller's Gaussians stay as they are
        gaussians = gaussians.replace(**{
            f.name: getattr(gaussians, f.name).detach().clone()
            for f in dataclasses.fields(gaussians)})
        params0 = float_params(gaussians)
        exposure0 = bilagrid0 = None
        if cfg.exposure:
            exposure0 = params0["exposure"] = identity_exposure(len(frames),
                                                                device=dev)
        if cfg.bilateral_grid:
            bilagrid0 = params0["bilagrid"] = identity_bilagrid(
                len(frames), cfg.bilagrid_shape, device=dev)
        self.state = TrainState(
            gaussians=gaussians,
            opt_state=_optimizer(cfg).init(params0),
            densify_state=DensifyState.zero(gaussians.capacity, device=dev),
            step=0,
            generator=torch.Generator().manual_seed(0),
            exposure=exposure0,
            bilagrid=bilagrid0,
        )
        # cameras moved to the device once, not on every step
        self._cams = [f.camera.to(dev) for f in frames]
        self._train_step = make_train_step(cfg, impl)
        self._fused_steps_fn = None
        if cfg.fused_steps > 1 and len(
                {(f.camera.width, f.camera.height) for f in frames}) == 1:
            self._fused_steps_fn = make_fused_train_steps(cfg, impl)
        self._frame_stack = None
        self._densify_step = make_densify_step(cfg)
        self._pool_max = gaussians.capacity
        self.history: List[Dict] = []

    @property
    def device(self) -> torch.device:
        return self.state.gaussians.device

    def _maybe_resize_pool(self, step: int):
        """Compact live Gaussians to a prefix and resize the pool to the
        alive count (+ spawn headroom during densification), bounded by
        the initially allocated capacity. Runs at densify-interval
        boundaries, where reading num_alive on the host is acceptable."""
        cfg = self.cfg
        n_alive = int(self.state.gaussians.num_alive)
        in_densify = cfg.densify_from <= step < cfg.densify_until
        headroom = cfg.pool_headroom if in_densify else 0.02
        want = int(n_alive * (1.0 + headroom)) + 1
        want = -(-want // cfg.pool_bucket) * cfg.pool_bucket
        want = min(want, self._pool_max)
        if want != self.state.gaussians.capacity and want >= n_alive:
            with torch.no_grad():
                g, opt, d = compact_and_resize(self.state.gaussians,
                                               self.state.opt_state,
                                               self.state.densify_state, want)
            self.state = dataclasses.replace(
                self.state, gaussians=g, opt_state=opt, densify_state=d)

    def targets(self):
        return [np.asarray(f.load(self.cfg.background)) for f in self.frames]

    def run(self, iterations: Optional[int] = None, progress: bool = True,
            on_log=None):
        """on_log: optional callable(metrics_dict) invoked at every log
        interval."""
        cfg = self.cfg
        iters = iterations or cfg.iterations
        dev = self.device
        targets_np = self.targets()
        depths_np = None
        if cfg.depth_lambda > 0.0:
            depths_np = [f.load_depth() for f in self.frames]
            if any(d is None for d in depths_np):
                raise ValueError("depth_lambda > 0 but some frames carry "
                                 "no depth (Frame.depth / depth_path)")
        total_bytes = sum(t.nbytes for t in targets_np)
        host = (cfg.host_data if cfg.host_data is not None
                else total_bytes > cfg.host_data_threshold)
        pin = host and dev.type == "cuda"

        def host_tensor(a):
            t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
            return t.pin_memory() if pin else t

        frames_host = [(host_tensor(t), None if depths_np is None
                        else host_tensor(depths_np[i]))
                       for i, t in enumerate(targets_np)]

        def upload(i):
            t, d = frames_host[i]
            return (t.to(dev, non_blocking=True),
                    None if d is None else d.to(dev, non_blocking=True))

        n = len(self.frames)
        step0 = self.state.step
        # fused chunks read every frame from device-resident stacks
        fused = int(cfg.fused_steps or 0)
        if host or self._fused_steps_fn is None:
            fused = 0
        if host:
            # one step ahead: the next target's copy overlaps this step
            pending = upload(step0 % n)
        elif fused > 1:
            if self._frame_stack is None:   # kept: the graph reads it
                self._frame_stack = stack_frames(
                    [f.camera for f in self.frames], targets_np, depths_np,
                    dev)
            stack = self._frame_stack
        else:
            targets = [upload(i) for i in range(n)]

        def host_event(s: int) -> bool:
            """Whether the loop does anything between step s and s + 1
            (pool resize, densify, opacity reset, checkpoint): a fused
            chunk may end on such a step, never run past one."""
            if s <= 0:
                return False
            if (s % cfg.densify_interval == 0
                    and ((cfg.dynamic_pool and s >= cfg.densify_from)
                         or cfg.densify_from <= s < cfg.densify_until)):
                return True
            if s % cfg.opacity_reset_interval == 0:
                return True
            return bool(cfg.checkpoint_dir) and s % cfg.checkpoint_every == 0

        def log(m, step):
            m["step"] = step
            m["elapsed"] = time.time() - t0
            self.history.append(m)
            if on_log is not None:
                on_log(m)
            if progress:
                extra = (f" OVERFLOW={int(m['overflow'])}"
                         if m.get("overflow") else "")
                print(f"[{step:6d}] loss={m['loss']:.4f} psnr={m['psnr']:.2f} "
                      f"alive={int(m['n_alive'])}{extra} ({m['elapsed']:.1f}s)")

        t0 = time.time()
        i = 0
        while i < iters:
            step = step0 + i
            if (fused > 1 and i + fused <= iters
                    and not any(host_event(step + j)
                                for j in range(fused - 1))):
                # a host event may land on the chunk's last step only
                # (it runs after the chunk, where the unfused loop runs it)
                self.state, mstack = self._fused_steps_fn(self.state, stack,
                                                          fused)
                log_js = [j for j in range(fused)
                          if (step + j) % cfg.log_every == 0]
                if log_js:
                    with span("train.log"):
                        mhost = {k: v.cpu().numpy()
                                 for k, v in mstack.items()}
                        for j in log_js:
                            log({k: float(v[j]) for k, v in mhost.items()},
                                step + j)
                i += fused
                step = step0 + i - 1      # the last step run, for events
            else:
                idx = step % n
                if host:
                    target, tdepth = pending
                    pending = upload((step + 1) % n)
                elif fused > 1:
                    target, tdepth = stack.target(idx), stack.depth(idx)
                else:
                    target, tdepth = targets[idx]
                self.state, metrics = self._train_step(
                    self.state, self._cams[idx], target, idx, tdepth)
                if step % cfg.log_every == 0:
                    with span("train.log"):
                        log({k: float(v) for k, v in metrics.items()}, step)
                i += 1

            if (cfg.dynamic_pool and step > 0
                    and step % cfg.densify_interval == 0
                    and step >= cfg.densify_from):
                with span("train.pool_resize"):
                    self._maybe_resize_pool(step)
            if (cfg.densify_from <= step < cfg.densify_until
                    and step > 0 and step % cfg.densify_interval == 0):
                with span("train.densify"):
                    self.state = self._densify_step(
                        self.state, step >= cfg.densify.prune_scale3d_after)
            if step > 0 and step % cfg.opacity_reset_interval == 0:
                self.state = dataclasses.replace(
                    self.state,
                    gaussians=reset_opacities(self.state.gaussians,
                                              cfg.densify.reset_opacity_value),
                    opt_state=_zero_opacity_moments(self.state.opt_state))
            if cfg.checkpoint_dir and step > 0 and step % cfg.checkpoint_every == 0:
                self.save_checkpoint()
        return self.state

    def eval_psnr(self) -> float:
        return self.eval_metrics()["psnr"]

    def eval_metrics(self) -> dict:
        """Held-out PSNR + SSIM (the splatfacto evaluation pair),
        averaged over eval frames (train frames when none held out)."""
        dev = self.device
        bg = torch.tensor(self.cfg.background, dtype=torch.float32, device=dev)
        psnrs, ssims = [], []
        with torch.no_grad():
            for f in (self.eval_frames or self.frames):
                out = rasterize(self.state.gaussians, f.camera.to(dev),
                                self.cfg.render, background=bg, impl=self.impl)
                tgt = torch.from_numpy(
                    np.asarray(f.load(self.cfg.background))).to(dev)
                psnrs.append(float(psnr(out["rgb"], tgt)))
                ssims.append(float(ssim(torch.clamp(out["rgb"], 0.0, 1.0),
                                        tgt)))
        return {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}

    # -- checkpointing ----------------------------------------------------

    def save_checkpoint(self, path: Optional[str] = None) -> str:
        """Write <path or cfg.checkpoint_dir>/step_<step>.pt (atomically);
        returns the file's path."""
        path = os.path.abspath(path or self.cfg.checkpoint_dir)
        os.makedirs(path, exist_ok=True)
        st = self.state
        obj = {
            "step": st.step,
            "gaussians": {f.name: getattr(st.gaussians, f.name)
                          for f in dataclasses.fields(st.gaussians)},
            "opt_state": {k: {f.name: getattr(s, f.name)
                              for f in dataclasses.fields(s)}
                          for k, s in st.opt_state.items()},
            "densify_state": {f.name: getattr(st.densify_state, f.name)
                              for f in dataclasses.fields(st.densify_state)},
            "generator": st.generator.get_state(),
            "exposure": st.exposure,
            "bilagrid": st.bilagrid,
        }
        out = os.path.join(path, f"step_{st.step}.pt")
        tmp = f"{out}.{os.getpid()}.tmp"
        torch.save(obj, tmp)
        os.replace(tmp, out)
        return out

    def restore_checkpoint(self, path: str):
        """Load a checkpoint written by save_checkpoint (its capacity may
        differ from the current pool's: dynamic_pool runs resize)."""
        obj = torch.load(path, map_location="cpu", weights_only=True)
        dev = self.device

        def to_dev(d):
            return {k: None if v is None else v.to(dev) for k, v in d.items()}

        gen = torch.Generator()
        gen.set_state(obj["generator"])
        self.state = TrainState(
            gaussians=Gaussians(**to_dev(obj["gaussians"])),
            opt_state={k: AdamGroup(**to_dev(s))
                       for k, s in obj["opt_state"].items()},
            densify_state=DensifyState(**to_dev(obj["densify_state"])),
            step=int(obj["step"]),
            generator=gen,
            exposure=None if obj.get("exposure") is None
            else obj["exposure"].to(dev),
            bilagrid=None if obj.get("bilagrid") is None
            else obj["bilagrid"].to(dev),
        )

    def resume_latest(self) -> bool:
        """Preemption recovery: restore the newest checkpoint in
        cfg.checkpoint_dir if any (the deterministic camera order makes
        the resumed run continue the exact data schedule). Returns True
        if restored."""
        d = self.cfg.checkpoint_dir
        if not d or not os.path.isdir(d):
            return False
        steps = []
        for name in os.listdir(d):
            if name.startswith("step_") and name.endswith(".pt"):
                try:
                    steps.append((int(name[len("step_"):-len(".pt")]), name))
                except ValueError:
                    continue
        if not steps:
            return False
        _, latest = max(steps)
        self.restore_checkpoint(os.path.join(d, latest))
        return True
