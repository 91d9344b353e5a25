"""A diffusion policy for a 2-joint object, trained on rendered rollouts
and evaluated in closed loop inside the renderer.

    python -m robosimgs_tpu_torch.tools.policy_multidof [out_dir]
        [--episodes 56] [--ep-len 36] [--steps 7000] [--eval-episodes 8]
        [--eval-steps 36] [--ddim-steps 50] [--device cuda]

A port of the JAX package's scripts/train_policy_multidof.py, with its
parameters, numpy seeds and output keys. The object is a box BODY with
a LID hinged at the back (+x axis) and a FLAP hinged at the front (-x
axis): two independent revolute joints, written as a URDF and three
GLB boxes. A scripted expert opens both at randomized speeds in front
of 2,000 background Gaussians (SH 1) pushed out to at least 1.7 times
the object's radius; every episode is rendered at 64x64 from a jittered
camera. The policy predicts a 2-dim action chunk from (image, 2-joint
state) windows, and a closed-loop episode succeeds when both joints end
within 0.15 rad of their targets (1.57, 1.2).

Every draw of the dataset and of the evaluation's start poses comes
from np.random.default_rng(0) in the JAX script's order, so the states,
actions and episode ends are the script's bit for bit. The background
is drawn by Gaussians.random from a torch.Generator seeded 3, whose
numbers differ from jax.random.PRNGKey(3)'s. The dataset is cached in
<out_dir>/dataset.npz and read back by a later run (which then draws
the evaluation's start poses from a fresh rng, as the script does).

Writes <out_dir>/results.json, the URDF, the GLBs and two PNGs of the
first episode.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from robosimgs_tpu_torch.cli.render import write_png
from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.core.types import Gaussians
from robosimgs_tpu_torch.policy.diffusion import DiffusionPolicyConfig
from robosimgs_tpu_torch.policy.rollout_eval import run_closed_loop
from robosimgs_tpu_torch.policy.trainer import (PolicyTrainConfig,
                                                PolicyTrainer, RolloutDataset)
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.scenegen.rollout import (ArticulatedObject,
                                                  render_rollout)
from robosimgs_tpu_torch.tools import workloads
from robosimgs_tpu_torch.tools.flagship import box
from robosimgs_tpu_torch.utils.meshio import save_mesh

URDF = """<?xml version="1.0"?>
<robot name="twojoint">
  <link name="body">
    <visual><geometry><mesh filename="body.glb" scale="1 1 1"/></geometry>
      <material name="m"><color rgba="0.75 0.65 0.45 1.0"/></material></visual>
    <inertial><mass value="0.5"/>
      <inertia ixx="0.01" ixy="0" ixz="0" iyy="0.01" iyz="0" izz="0.01"/>
    </inertial>
  </link>
  <link name="lid">
    <visual><geometry><mesh filename="lid.glb" scale="1 1 1"/></geometry>
      <material name="m2"><color rgba="0.35 0.75 0.4 1.0"/></material></visual>
    <inertial><mass value="0.2"/>
      <inertia ixx="0.01" ixy="0" ixz="0" iyy="0.01" iyz="0" izz="0.01"/>
    </inertial>
  </link>
  <link name="flap">
    <visual><geometry><mesh filename="flap.glb" scale="1 1 1"/></geometry>
      <material name="m3"><color rgba="0.4 0.45 0.85 1.0"/></material></visual>
    <inertial><mass value="0.1"/>
      <inertia ixx="0.01" ixy="0" ixz="0" iyy="0.01" iyz="0" izz="0.01"/>
    </inertial>
  </link>
  <joint name="lid_hinge" type="revolute">
    <parent link="body"/><child link="lid"/>
    <origin xyz="0 0.5 0.2" rpy="0 0 0"/>
    <axis xyz="1 0 0"/>
    <limit lower="0.0" upper="1.57" effort="5" velocity="2"/>
    <dynamics friction="0.5" damping="0.2"/>
  </joint>
  <joint name="flap_hinge" type="revolute">
    <parent link="body"/><child link="flap"/>
    <origin xyz="0 -0.5 0.2" rpy="0 0 0"/>
    <axis xyz="-1 0 0"/>
    <limit lower="0.0" upper="1.2" effort="5" velocity="2"/>
    <dynamics friction="0.5" damping="0.2"/>
  </joint>
</robot>"""

TARGETS_Q = np.array([1.57, 1.2], np.float32)
CENTER = np.array([0.0, 0.0, 0.3], np.float32)
RADIUS = 1.3
BASE_EYE = CENTER + np.array([1.3, 0.3, 0.55], np.float32)
RES = 64
RENDER = RenderConfig(tile_capacity=256, max_tiles_per_gaussian=8)
# a closed-loop episode succeeds when every joint ends this close (rad)
SUCCESS_TOL = 0.15


def write_object(out_dir: str) -> ArticulatedObject:
    """Write body/lid/flap GLBs and robot.urdf into out_dir and load the
    object. The lid covers the back half of the top and the flap the
    front half (coplanar overlap z-fights), each offset from its joint
    frame so that its rotation shows."""
    os.makedirs(out_dir, exist_ok=True)
    origin = (0.0, 0.0, 0.0)
    save_mesh(os.path.join(out_dir, "body.glb"), box(origin, (0.55, 0.5, 0.2)))
    save_mesh(os.path.join(out_dir, "lid.glb"),
              box(origin, (0.5, 0.28, 0.04)).translated([0, -0.28, 0.0]))
    save_mesh(os.path.join(out_dir, "flap.glb"),
              box(origin, (0.5, 0.2, 0.04)).translated([0, 0.2, 0.0]))
    path = os.path.join(out_dir, "robot.urdf")
    with open(path, "w") as fh:
        fh.write(URDF)
    obj = ArticulatedObject.from_urdf(path)
    assert obj.model.dof == 2, obj.model.dof
    return obj


def background(device="cuda") -> Gaussians:
    """2,000 random Gaussians (SH 1, extent 3.9) pushed to at least 1.7
    radii from the origin, then centred on the object."""
    bg = Gaussians.random(torch.Generator().manual_seed(3), 2000,
                          sh_degree=1, extent=3.0 * RADIUS, device="cpu")
    m = bg.means.numpy()
    d = np.linalg.norm(m, axis=1, keepdims=True)
    push = np.maximum(1.7 * RADIUS, d) / np.maximum(d, 1e-6)
    return bg.replace(means=torch.from_numpy(
        (m * push + CENTER).astype(np.float32))).to(device)


def draw_episode(rng: np.random.Generator, ep_len: int):
    """(trajectory (ep_len + 1, 2) float32, eye): the expert's start pose,
    speeds, camera jitter and per-step noise, in the script's order."""
    q0 = rng.uniform(0.0, 0.4, 2).astype(np.float32)
    speed = rng.uniform(0.03, 0.09, 2)
    eye = BASE_EYE + rng.normal(0, 0.04 * RADIUS, 3)
    qs = [q0]
    for _ in range(ep_len):
        step = speed + rng.normal(0, 0.004, 2)
        qs.append(np.minimum(TARGETS_Q, qs[-1] + np.maximum(step, 0.0)
                             ).astype(np.float32))
    return np.stack(qs), eye


def make_dataset(obj: ArticulatedObject, bg: Gaussians,
                 rng: np.random.Generator, n_eps: int = 56, ep_len: int = 36,
                 out_dir=None, progress: bool = True) -> RolloutDataset:
    """Render n_eps expert episodes on the background's device (one
    forward launch a frame on a card); with out_dir, the first
    episode's first and last frames as PNGs."""
    images, states, actions, ends = [], [], [], []
    t0 = time.time()
    count = 0
    for e in range(n_eps):
        traj, eye = draw_episode(rng, ep_len)
        cam = Camera.look_at(eye, CENTER, [0, 0, 1], 55.0, RES, RES,
                             device=bg.device)
        frames = render_rollout(bg, [obj], traj[:-1], [cam], cfg=RENDER)
        frames = np.asarray(frames[:, 0], np.float32)
        images.append(frames)
        states.append(traj[:-1])
        actions.append(traj[1:])
        count += ep_len
        ends.append(count)
        if e == 0 and out_dir is not None:
            for t in (0, ep_len - 1):
                write_png(os.path.join(out_dir, f"ep0_t{t:02d}.png"),
                          (np.clip(frames[t], 0, 1) * 255).astype(np.uint8))
        if progress and (e + 1) % 8 == 0:
            print(f"  rendered {e + 1}/{n_eps} ({time.time() - t0:.1f}s)",
                  flush=True)
    return RolloutDataset(images=np.concatenate(images),
                          states=np.concatenate(states).astype(np.float32),
                          actions=np.concatenate(actions).astype(np.float32),
                          episode_ends=ends)


def policy_config(total_steps: int = 7000) -> PolicyTrainConfig:
    pc = DiffusionPolicyConfig(action_dim=2, horizon=8, obs_horizon=2,
                               image_size=(RES, RES), state_dim=2,
                               embed_dim=64, hidden_dim=128, n_blocks=3,
                               diffusion_steps=50)
    return PolicyTrainConfig(policy=pc, lr=1e-3, warmup_steps=100,
                             total_steps=total_steps, batch_size=64,
                             ema_decay=0.995)


def train(ds: RolloutDataset, steps: int = 7000, device="cuda",
          progress: bool = True) -> PolicyTrainer:
    """PolicyTrainer (seed 0) over `steps`, in chunks of 500."""
    tr = PolicyTrainer(policy_config(steps), ds, seed=0, device=device)
    for chunk in range(0, steps, 500):
        tr.run(steps=min(500, steps - chunk), log_every=250,
               progress=progress)
    return tr


def closed_loop(tr: PolicyTrainer, obj: ArticulatedObject, bg: Gaussians,
                rng: np.random.Generator, n_eval: int = 8, steps: int = 36,
                ddim_steps: int = 50, progress: bool = True):
    """(successes, final joint angles): n_eval episodes from start poses
    drawn by rng, from the undisturbed camera, 4 actions a prediction."""
    pc = tr.cfg.policy

    def policy(im, s):
        return tr.predict(im, s, n_steps=ddim_steps)

    succ, finals = 0, []
    for i in range(n_eval):
        q0 = rng.uniform(0.0, 0.4, 2).astype(np.float32)
        cam = Camera.look_at(BASE_EYE, CENTER, [0, 0, 1], 55.0, RES, RES,
                             device=bg.device)
        res = run_closed_loop(policy, bg, obj, [cam], steps=steps,
                              obs_horizon=pc.obs_horizon, actions_per_step=4,
                              q0=q0, target_q=TARGETS_Q, cfg=RENDER,
                              device=bg.device)
        qf = res.joint_history[-1]
        finals.append([round(float(v), 3) for v in qf])
        ok = bool(np.all(np.abs(qf - TARGETS_Q) < SUCCESS_TOL))
        succ += ok
        if progress:
            print(f"  eval {i}: q0={q0.round(2).tolist()} -> "
                  f"{qf.round(3).tolist()} {'OK' if ok else 'MISS'}",
                  flush=True)
    return succ, finals


def run(out_dir: str, n_eps: int = 56, ep_len: int = 36, steps: int = 7000,
        n_eval: int = 8, eval_steps: int = 36, ddim_steps: int = 50,
        device="cuda", progress: bool = True) -> dict:
    """The whole run; writes <out_dir>/results.json and returns its dict
    with the seconds of each stage beside it (under "seconds", which
    the file does not hold)."""
    dev = torch.device(device)
    obj = write_object(out_dir)
    if progress:
        print(f"2-dof object: joints {[j.name for j in obj.model.movable]}",
              flush=True)
    bg = background(dev)
    rng = np.random.default_rng(0)
    cache = os.path.join(out_dir, "dataset.npz")
    t0 = time.time()
    if os.path.exists(cache):
        z = np.load(cache)
        ds = RolloutDataset(images=z["images"], states=z["states"],
                            actions=z["actions"],
                            episode_ends=list(z["ends"]))
        if progress:
            print(f"loaded cached dataset: {ds.images.shape[0]} frames",
                  flush=True)
    else:
        ds = make_dataset(obj, bg, rng, n_eps, ep_len, out_dir, progress)
        np.savez_compressed(cache, images=ds.images, states=ds.states,
                            actions=ds.actions,
                            ends=np.asarray(ds.episode_ends))
    t_data = time.time() - t0

    t0 = time.time()
    tr = train(ds, steps, dev, progress)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_train = time.time() - t0
    if progress:
        print(f"trained {steps} steps in {t_train:.1f}s, loss "
              f"{tr.history[0]['loss']:.4f} -> {tr.history[-1]['loss']:.4f}",
              flush=True)

    t0 = time.time()
    succ, finals = closed_loop(tr, obj, bg, rng, n_eval, eval_steps,
                               ddim_steps, progress)
    t_eval = time.time() - t0
    results = {
        "object": {"dof": 2, "targets": TARGETS_Q.tolist()},
        "dataset": {"episodes": n_eps, "ep_len": ep_len, "res": RES},
        "training": {"steps": steps,
                     "loss_first": round(tr.history[0]["loss"], 4),
                     "loss_last": round(tr.history[-1]["loss"], 4)},
        "closed_loop": {"episodes": n_eval, "steps": eval_steps,
                        "success": succ, "final_angles": finals,
                        "eval_s": round(t_eval, 1)},
    }
    with open(os.path.join(out_dir, "results.json"), "w") as fh:
        json.dump(results, fh, indent=1)
    if progress:
        print(json.dumps(results), flush=True)
    return {**results, "seconds": {"dataset": t_data, "train": t_train,
                                   "eval": t_eval}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", nargs="?", default="policy_multidof")
    ap.add_argument("--episodes", type=int, default=56)
    ap.add_argument("--ep-len", type=int, default=36)
    ap.add_argument("--steps", type=int, default=7000)
    ap.add_argument("--eval-episodes", type=int, default=8)
    ap.add_argument("--eval-steps", type=int, default=36)
    ap.add_argument("--ddim-steps", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if workloads.open_device(args.device, "policy_multidof") is None:
        return 1
    run(args.out_dir, n_eps=args.episodes, ep_len=args.ep_len,
        steps=args.steps, n_eval=args.eval_episodes,
        eval_steps=args.eval_steps, ddim_steps=args.ddim_steps,
        device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
