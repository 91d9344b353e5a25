"""Where the port's mask-model trainer and the JAX package's part: both
train_masknet functions on the CPU from the same start, losses step by
step.

    env JAX_PLATFORMS=cpu python tests/masknet_drift.py [steps] [size]
        [--out drift.json]

Both trainers run the JAX script's plain training (160 scenes, seed 0),
draw their batches from numpy's generator seeded 0 and are handed the
same parameters, flax's initialisers at PRNGKey(0) (the port's own
draw from a torch.Generator), and the same scenes: the JAX package's
make_scene is replaced by the port's, as
tests/test_torch_train_masknet_tool.py does (mesh edges may flip a
pixel between the two). What differs is the arithmetic: XLA's CPU
kernels and reduction order against torch's, and the port's GroupNorm
statistics.

Prints, for each power of ten from 1e-6 to 1e-1, the first step whose
losses differ by more than that relative amount, the losses every
EVERY steps, both held-out prompt-mask IoUs, and a last `RESULT
{json}` line (also written to --out, with every step's losses).

A measurement, not a test: pytest does not collect it (no test_ prefix),
and it imports both packages, as the port's tests do.
"""

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from robosimgs_tpu.artic import masknet as jm  # noqa: E402

from robosimgs_tpu_torch.artic import masknet as pm  # noqa: E402
from robosimgs_tpu_torch.core.convert import \
    masknet_params_from_numpy  # noqa: E402

THRESHOLDS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)
EVERY = 25
SCENES, SEED = 160, 0


def port_scene(seed, size, max_parts=3, scan_like=False, flap=False):
    return pm.make_scene(seed, size, max_parts, scan_like, flap,
                         device="cpu")


def first_parting(rel) -> dict:
    """{threshold: the first step whose relative loss difference `rel`
    exceeds it, or None}."""
    return {f"{t:g}": (int(np.argmax(rel > t)) if (rel > t).any() else None)
            for t in THRESHOLDS}


def drift(steps: int, size: int, scenes: int, seed: int) -> dict:
    kw = dict(steps=steps, size=size, batch=16, n_scenes=scenes, lr=2e-3,
              seed=seed, log_every=0)
    init = jm.MaskUNet().init(jax.random.PRNGKey(seed),
                              jnp.zeros((1, size, size, 4)))
    real_scene = jm.make_scene
    jm.make_scene = port_scene
    try:
        t0 = time.perf_counter()
        want = jm.train_masknet(init_params=init, **kw)
        jax_s = time.perf_counter() - t0
    finally:
        jm.make_scene = real_scene
    t0 = time.perf_counter()
    got = pm.train_masknet(
        init_params=masknet_params_from_numpy(jax.device_get(init)),
        device="cpu", **kw)
    port_s = time.perf_counter() - t0
    rel = (np.abs(np.asarray(want.losses) - np.asarray(got.losses))
           / np.abs(np.asarray(want.losses)))
    return {"steps": steps, "size": size, "scenes": scenes, "seed": seed,
            "first_step_past": first_parting(rel),
            "max_rel_loss_diff": float(rel.max()),
            "jax_holdout_iou": want.holdout_iou,
            "port_holdout_iou": got.holdout_iou,
            "jax_s": jax_s, "port_s": port_s,
            "jax_losses": list(map(float, want.losses)),
            "port_losses": list(map(float, got.losses))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", type=int, nargs="?", default=300)
    ap.add_argument("size", type=int, nargs="?", default=32)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = drift(args.steps, args.size, SCENES, SEED)
    for s in range(0, args.steps, EVERY):
        print(f"step {s}: jax {res['jax_losses'][s]:.6f} port "
              f"{res['port_losses'][s]:.6f}", flush=True)
    print("first step past each relative difference: "
          + json.dumps(res["first_step_past"]))
    print(f"held-out IoU: jax {res['jax_holdout_iou']:.4f} port "
          f"{res['port_holdout_iou']:.4f} ({res['jax_s']:.0f} s / "
          f"{res['port_s']:.0f} s)")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh)
    summary = {k: v for k, v in res.items()
               if k not in ("jax_losses", "port_losses")}
    print("RESULT " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
