"""Action-chunking inference for diffusion policies.

A copy of robosimgs_tpu/policy/inference.py (numpy, host-side), for the
deployment side of the policy stage. A diffusion policy predicts a
`horizon`-length action chunk per inference call; executing the whole
chunk open-loop is cheap but drifts, while replanning every step wastes
inference. `ActionChunker` implements the two standard strategies:

- **receding horizon** (Diffusion Policy): execute the first
  `replan_every` actions of each chunk, then replan;
- **temporal ensembling** (ACT): replan every step and execute, at
  time t, the exponentially-weighted average of every live chunk's
  prediction for t — older chunks get weight exp(-ensemble_alpha * age).
  Smooths chunk-boundary discontinuities at the cost of one inference
  per step.

Stateful and host-side by design: it owns the observation history
(padding the warm-up steps by repeating the first observation, the
convention `rollout_eval.run_closed_loop` uses) and the action queue;
the policy_fn it wraps is `PolicyTrainer.predict`.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, List, Optional, Tuple

import numpy as np

PolicyFn = Callable[[np.ndarray, np.ndarray], np.ndarray]


@dataclasses.dataclass
class ActionChunker:
    """Wraps policy_fn(images (1, obs_horizon, H, W, 3), states
    (1, obs_horizon, dof)) -> (1, horizon, dof) into a per-step
    `step(image, state) -> action` interface."""

    policy_fn: PolicyFn
    obs_horizon: int
    horizon: int
    replan_every: int = 4
    ensemble: bool = False
    ensemble_alpha: float = 0.1

    def __post_init__(self):
        if not (1 <= self.replan_every <= self.horizon):
            raise ValueError(
                f"replan_every={self.replan_every} outside [1, horizon="
                f"{self.horizon}]")
        self.reset()

    def reset(self) -> None:
        self._obs_imgs: Deque[np.ndarray] = deque(maxlen=self.obs_horizon)
        self._obs_states: Deque[np.ndarray] = deque(maxlen=self.obs_horizon)
        self._queue: List[np.ndarray] = []
        # live chunks for ensembling: (start_step, (horizon, dof) chunk)
        self._chunks: List[Tuple[int, np.ndarray]] = []
        self._t = 0
        self.n_inferences = 0

    def _observe(self, image: np.ndarray, state: np.ndarray) -> None:
        self._obs_imgs.append(np.asarray(image, np.float32))
        self._obs_states.append(np.asarray(state, np.float32))

    def _stacked_obs(self) -> Tuple[np.ndarray, np.ndarray]:
        imgs = list(self._obs_imgs)
        sts = list(self._obs_states)
        while len(imgs) < self.obs_horizon:   # warm-up: repeat first obs
            imgs = [imgs[0]] + imgs
            sts = [sts[0]] + sts
        return np.stack(imgs)[None], np.stack(sts)[None]

    def _infer(self) -> np.ndarray:
        imgs, sts = self._stacked_obs()
        chunk = np.asarray(self.policy_fn(imgs, sts))[0]
        self.n_inferences += 1
        return chunk

    def step(self, image: np.ndarray, state: np.ndarray) -> np.ndarray:
        """Feed the newest observation, get the action for this step."""
        self._observe(image, state)
        if self.ensemble:
            return self._step_ensemble()
        if not self._queue:
            chunk = self._infer()
            self._queue = list(chunk[: self.replan_every])
        action = self._queue.pop(0)
        self._t += 1
        return action

    def _step_ensemble(self) -> np.ndarray:
        t = self._t
        self._chunks.append((t, self._infer()))
        # keep only chunks that still cover step t
        self._chunks = [(s, c) for s, c in self._chunks
                        if t - s < self.horizon]
        preds, weights = [], []
        for start, chunk in self._chunks:
            age = t - start
            preds.append(chunk[age])
            weights.append(np.exp(-self.ensemble_alpha * age))
        w = np.asarray(weights, np.float32)
        w = w / w.sum()
        self._t += 1
        return (np.stack(preds) * w[:, None]).sum(axis=0)
