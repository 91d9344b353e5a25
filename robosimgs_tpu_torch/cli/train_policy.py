"""Diffusion-policy training CLI (pipeline stage 5).

The port of robosimgs_tpu/cli/train_policy.py, with the same flags plus
`--device` (default cuda). Consumes rendered rollout data (the output
contract of cli.render_rollout: frame_{t:04d}_cam{c}.png + a (T, dof)
trajectory), trains a receding-horizon diffusion policy on it and writes
policy.pt (torch.save of the EMA weights, the normalization and the
config as a plain dict; policy/trainer.py::load_policy reads it, with
weights_only=True) and train_summary.json.

    python -m robosimgs_tpu_torch.cli.train_policy --frames frames \\
        --trajectory traj.npy --steps 10000 --output policy/
"""

from __future__ import annotations

import argparse
import json
import os


def build_parser():
    p = argparse.ArgumentParser(description="Train a diffusion policy on "
                                            "rendered rollout data")
    p.add_argument("--frames", required=True, action="append",
                   help="rollout frame dir (repeatable, one per episode)")
    p.add_argument("--trajectory", required=True, action="append",
                   help="matching (T, dof) .npy joint trajectory per episode")
    p.add_argument("--camera", type=int, default=0,
                   help="camera index to train on")
    p.add_argument("--output", required=True)
    p.add_argument("--steps", type=int, default=10_000)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--horizon", type=int, default=16)
    p.add_argument("--obs-horizon", type=int, default=2)
    p.add_argument("--image-size", type=int, default=96)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: cuda)")
    return p


def load_episode(frames_dir: str, traj_path: str, camera: int, size: int):
    """(T, size, size, 3) float32 frames in [0, 1] and the (T, dof)
    trajectory; frames are resized as Pillow's BICUBIC resize does."""
    import numpy as np

    from robosimgs_tpu_torch.utils.imresize import (read_png_rgb,
                                                    resize_bicubic)

    traj = np.load(traj_path).astype(np.float32)
    images = []
    for t in range(traj.shape[0]):
        path = os.path.join(frames_dir, f"frame_{t:04d}_cam{camera}.png")
        img = resize_bicubic(read_png_rgb(path), size, size)
        images.append(img.astype(np.float32) / 255.0)
    return np.stack(images), traj


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np

    from robosimgs_tpu_torch.policy.diffusion import DiffusionPolicyConfig
    from robosimgs_tpu_torch.policy.trainer import (PolicyTrainConfig,
                                                    PolicyTrainer,
                                                    RolloutDataset,
                                                    save_policy)

    if len(args.frames) != len(args.trajectory):
        raise SystemExit("--frames and --trajectory counts must match")
    images, states, actions, ends = [], [], [], []
    count = 0
    for fd, tp in zip(args.frames, args.trajectory):
        imgs, traj = load_episode(fd, tp, args.camera, args.image_size)
        images.append(imgs)
        # proprioception = current joint state; action = next joint state
        states.append(traj)
        actions.append(np.concatenate([traj[1:], traj[-1:]], 0))
        count += traj.shape[0]
        ends.append(count)
    ds = RolloutDataset(images=np.concatenate(images),
                        states=np.concatenate(states),
                        actions=np.concatenate(actions), episode_ends=ends)

    dof = ds.actions.shape[1]
    cfg = PolicyTrainConfig(
        policy=DiffusionPolicyConfig(
            action_dim=dof, state_dim=dof, horizon=args.horizon,
            obs_horizon=args.obs_horizon,
            image_size=(args.image_size, args.image_size)),
        lr=args.lr, total_steps=args.steps, batch_size=args.batch_size)
    trainer = PolicyTrainer(cfg, ds, device=args.device)
    trainer.run(steps=args.steps)

    os.makedirs(args.output, exist_ok=True)
    save_policy(os.path.join(args.output, "policy.pt"), trainer)
    with open(os.path.join(args.output, "train_summary.json"), "w") as fh:
        json.dump({"history": trainer.history, "episodes": len(ends),
                   "transitions": count}, fh, indent=2)
    print(f"policy saved to {args.output}/policy.pt")


if __name__ == "__main__":
    main()
