"""Closed-loop policy evaluation inside the renderer.

A port of robosimgs_tpu/policy/rollout_eval.py: the trained diffusion
policy drives the articulated object's joint state step by step while
the rollout renderer (scenegen/rollout.py) produces its camera
observations — a sim-eval loop with the renderer in the loop (contact
dynamics belong to an external simulator). Each observation renders
every camera once; on a CUDA device each camera composites its splats
through the compositing kernel, so a run of `steps` steps launches it
steps + 1 times per camera. Observations are resized to `image_size` as
the reference does (quantized to uint8 by truncation, then Pillow's
BICUBIC, here utils/imresize.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np

from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.core.types import Gaussians
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.mesh_raster import MeshRasterConfig
from robosimgs_tpu_torch.scenegen.rollout import (ArticulatedObject,
                                                  render_rollout)
from robosimgs_tpu_torch.utils.imresize import resize_bicubic


@dataclasses.dataclass
class ClosedLoopResult:
    joint_history: np.ndarray        # (T+1, dof)
    frames: np.ndarray               # (T, C, H, W, 3)
    action_history: np.ndarray       # (T, dof)
    final_error: Optional[float] = None


def run_closed_loop(
    policy_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
    background: Gaussians,
    obj: ArticulatedObject,
    cameras: Sequence[Camera],
    steps: int,
    obs_horizon: int = 2,
    actions_per_step: int = 4,
    q0: Optional[np.ndarray] = None,
    target_q: Optional[np.ndarray] = None,
    cfg: RenderConfig = RenderConfig(),
    mesh_cfg: MeshRasterConfig = MeshRasterConfig(),
    image_size: Optional[int] = None,
    camera_index: int = 0,
    chunker=None,
    device="cuda",
) -> ClosedLoopResult:
    """Receding-horizon closed loop: render obs -> policy -> apply the
    first `actions_per_step` actions as joint targets -> repeat, with
    the scene rendered on `device` (the background is moved there).

    policy_fn(images (B=1, obs_horizon, H, W, 3), states (1, obs_horizon,
    dof)) -> (1, horizon, dof) action sequence (PolicyTrainer.predict's
    signature). Joint limits are enforced via model.clamp.

    chunker: optional ActionChunker (policy/inference.py); when given it
    drives execution (temporal ensembling / receding horizon) instead of
    the plain first-`actions_per_step` loop, and policy_fn is unused.
    """
    background = background.to(device)
    dof = obj.model.dof
    q = np.zeros((dof,), np.float32) if q0 is None else np.asarray(q0, np.float32)
    q_hist = [q.copy()]
    frames_out: List[np.ndarray] = []
    actions_out: List[np.ndarray] = []
    obs_imgs: List[np.ndarray] = []
    obs_states: List[np.ndarray] = []

    def observe(q_now):
        f = render_rollout(background, [obj], q_now[None, :], cameras,
                           cfg=cfg, mesh_cfg=mesh_cfg, impl="auto")
        frames_out.append(f[0])
        img = f[0, camera_index]
        if image_size is not None and img.shape[0] != image_size:
            img = resize_bicubic((np.clip(img, 0, 1) * 255).astype(np.uint8),
                                 image_size, image_size
                                 ).astype(np.float32) / 255.0
        obs_imgs.append(img)
        obs_states.append(q_now.copy())

    def act(a):
        nonlocal q
        q = obj.model.clamp(np.asarray(a, np.float32))
        q_hist.append(q.copy())
        actions_out.append(np.asarray(a, np.float32))
        observe(q)

    observe(q)
    t = 0
    if chunker is not None:
        # the chunker owns obs stacking and the action queue; feed it the
        # newest observation per step
        chunker.reset()
        while t < steps:
            act(chunker.step(obs_imgs[-1], obs_states[-1]))
            t += 1
    while chunker is None and t < steps:
        # stack the most recent obs_horizon observations (pad with first)
        imgs = obs_imgs[-obs_horizon:]
        sts = obs_states[-obs_horizon:]
        while len(imgs) < obs_horizon:
            imgs = [imgs[0]] + imgs
            sts = [sts[0]] + sts
        actions = policy_fn(np.stack(imgs)[None], np.stack(sts)[None])[0]
        for a in actions[:actions_per_step]:
            if t >= steps:
                break
            act(a)
            t += 1

    err = (float(np.abs(q - np.asarray(target_q)).mean())
           if target_q is not None else None)
    return ClosedLoopResult(
        joint_history=np.stack(q_hist),
        frames=np.stack(frames_out[1:]) if len(frames_out) > 1
        else np.zeros((0,)),
        action_history=(np.stack(actions_out) if actions_out
                        else np.zeros((0, dof), np.float32)),
        final_error=err,
    )
