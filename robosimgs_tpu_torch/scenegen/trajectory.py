"""Simulator trajectory ingestion (the Genesis data contract).

A numpy copy of robosimgs_tpu/scenegen/trajectory.py (the port imports
nothing from the JAX package); both read and write the same files. What
the render side needs from the simulator is a pose stream. The
interchange format is JSON (or JSONL, one timestep per line):

    {
      "fps": 30,                         # optional metadata
      "objects": ["openbox", "arm"],     # object order (matches URDFs)
      "steps": [
        {"t": 0.0,
         "joints": {"openbox": [0.0], "arm": [0, 0.1, ...]},
         "base_poses": {"openbox": [[...4x4...]], ...}},   # optional
        ...
      ]
    }

`load_trajectory` returns the (T, total_dof) joint matrix and optional
(T, n_objects, 4, 4) base poses consumed by scenegen.render_rollout.
Unlisted joints hold their previous value; unlisted base poses hold the
object's resting pose.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

import numpy as np

from robosimgs_tpu_torch.scenegen.urdf_fk import URDFModel


def load_trajectory(
    path: str,
    models: Sequence[URDFModel],
    object_names: Optional[Sequence[str]] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Parse a trajectory file against the objects' URDF models.

    Returns (joints (T, total_dof), base_poses (T, n_obj, 4, 4) or None).
    """
    with open(path) as fh:
        text = fh.read().strip()
    if text.startswith("{"):
        data = json.loads(text)
        steps = data["steps"]
        names = data.get("objects", object_names)
    else:  # JSONL of steps
        steps = [json.loads(line) for line in text.splitlines() if line.strip()]
        names = object_names
    if names is None:
        names = [m.name for m in models]
    if len(names) != len(models):
        raise ValueError(f"{len(names)} object names vs {len(models)} models")

    dofs = [m.dof for m in models]
    total = sum(dofs)
    T = len(steps)
    joints = np.zeros((T, total), np.float32)
    have_base = any("base_poses" in s for s in steps)
    # NaN marks "never listed": render_rollout falls back to each
    # object's resting base_pose instead of overriding it with identity
    # (one object having base_poses must not reset the resting pose of
    # every other object)
    base = np.full((T, len(models), 4, 4), np.nan, np.float32) \
        if have_base else None

    prev = np.zeros((total,), np.float32)
    for t, s in enumerate(steps):
        row = prev.copy()
        jmap = s.get("joints", {})
        off = 0
        for name, model, d in zip(names, models, dofs):
            if name in jmap:
                vals = np.asarray(jmap[name], np.float32)
                if vals.shape != (d,):
                    raise ValueError(
                        f"step {t}: object {name!r} expects {d} joints, "
                        f"got {vals.shape}")
                row[off:off + d] = vals
            off += d
        joints[t] = row
        prev = row
        if have_base:
            bmap = s.get("base_poses", {})
            for i, name in enumerate(names):
                if name in bmap:
                    base[t, i] = np.asarray(bmap[name], np.float32)
                elif t > 0:
                    base[t, i] = base[t - 1, i]
    return joints, base


def save_trajectory(path: str, names: Sequence[str],
                    joints: np.ndarray,
                    base_poses: Optional[np.ndarray] = None,
                    dofs: Optional[List[int]] = None,
                    fps: float = 30.0) -> None:
    """Write the interchange format (inverse of load_trajectory)."""
    T = joints.shape[0]
    if dofs is None:
        dofs = [joints.shape[1] // len(names)] * len(names)
    steps = []
    for t in range(T):
        off = 0
        jmap = {}
        for name, d in zip(names, dofs):
            jmap[name] = joints[t, off:off + d].tolist()
            off += d
        step = {"t": t / fps, "joints": jmap}
        if base_poses is not None:
            step["base_poses"] = {name: base_poses[t, i].tolist()
                                  for i, name in enumerate(names)}
        steps.append(step)
    with open(path, "w") as fh:
        json.dump({"fps": fps, "objects": list(names), "steps": steps}, fh)
