"""Train the point-prompted mask model and report its held-out IoU
beside the checked-in weights'.

    python -m robosimgs_tpu_torch.tools.train_masknet [steps] [size]
        [--finetune] [--scenes 160] [--seed 0] [--out weights.msgpack]
        [--device cuda]

A port of the JAX package's scripts/train_masknet.py: steps (1,200) and
size (96) are its positional arguments, and MASKNET_FINETUNE,
MASKNET_SCENES and MASKNET_SEED are --finetune, --scenes and --seed,
mapped to the same artic/masknet.py::train_masknet arguments (batch 16,
a log line every 50 steps; --finetune: lr 5e-4, flap_frac 0.4, crop
augmentation, warm-started from the checked-in weights; else lr 2e-3
from the initialisers). It prints the held-out prompt-mask IoU, the
checked-in weights' IoU on the same held-out scenes, and each model's
automatic-generation best part IoU on six fresh scenes
(make_scene(777_100 + s, size)), then `RESULT {json}`.

The weights are written only to --out (flax's msgpack, save_params).
The checked-in artic/weights/masknet.msgpack is the JAX package's file
carried across, which the parity tests hold the port to: --out may not
name it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from robosimgs_tpu_torch.artic.masknet import (DEFAULT_WEIGHTS,
                                               MaskNetGenerator, MaskUNet,
                                               holdout_scenes, load_params,
                                               make_scene, prompt_iou,
                                               save_params, train_masknet)
from robosimgs_tpu_torch.tools import workloads
from robosimgs_tpu_torch.tools.k_equiv import device_name

FRESH = 6


def best_part_ious(params: dict, size: int, device) -> list:
    """For each of the FRESH fresh scenes, the best IoU of any generated
    mask with any of its parts."""
    gen = MaskNetGenerator(params, size=size, device=device)
    best_ious = []
    for s in range(FRESH):
        img, pid = make_scene(777_100 + s, size, device=device)
        masks = gen.generate(img)
        best = 0.0
        for p in np.unique(pid[pid >= 0]):
            gt = pid == p
            for m in masks:
                best = max(best, (m & gt).sum() / max((m | gt).sum(), 1))
        best_ious.append(float(best))
    return best_ious


def run(steps: int = 1200, size: int = 96, finetune: bool = False,
        scenes: int = 160, seed: int = 0, device="cuda",
        out: str | None = None, log=print) -> dict:
    """The script's run (see the module docstring); returns the RESULT
    dict. Raises ValueError if `out` is the checked-in weights."""
    if out and os.path.realpath(out) == os.path.realpath(DEFAULT_WEIGHTS):
        raise ValueError(f"--out {out} is the checked-in weights; write "
                         "elsewhere")
    log(f"device={device_name(device)} steps={steps} size={size} "
        f"finetune={finetune}")
    t0 = time.perf_counter()
    res = train_masknet(steps=steps, size=size, batch=16, n_scenes=scenes,
                        log_every=50, seed=seed,
                        init_params=load_params() if finetune else None,
                        lr=5e-4 if finetune else 2e-3,
                        flap_frac=0.4 if finetune else 0.0,
                        crop_aug=finetune, device=device)
    train_s = time.perf_counter() - t0
    log(f"trained in {train_s:.0f}s; holdout prompt-mask IoU "
        f"{res.holdout_iou:.3f}")
    checked_in = load_params()
    base = MaskUNet()
    base.load_state_dict(checked_in)
    base_iou = prompt_iou(base.to(device), holdout_scenes(
        size, 0.4 if finetune else 0.0, device), device)
    log(f"checked-in weights on the same held-out scenes: {base_iou:.3f}")
    if out:
        save_params(res.params, out)
        log(f"saved {out} ({os.path.getsize(out) / 1e6:.1f} MB)")
    best = best_part_ious(res.params, size, device)
    for s, b in enumerate(best):
        log(f"scene {s}: best part IoU {b:.3f}")
    log(f"mean best-IoU over fresh scenes: {np.mean(best):.3f}")
    base_best = best_part_ious(checked_in, size, device)
    log(f"checked-in weights: mean best-IoU {np.mean(base_best):.3f}")
    return {"steps": steps, "size": size, "finetune": finetune,
            "scenes": scenes, "seed": seed, "device": device_name(device),
            "train_s": train_s, "holdout_iou": res.holdout_iou,
            "checked_in_holdout_iou": base_iou,
            "losses": res.losses,
            "best_ious": best, "mean_best_iou": float(np.mean(best)),
            "checked_in_mean_best_iou": float(np.mean(base_best)),
            "out": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", type=int, nargs="?", default=1200)
    ap.add_argument("size", type=int, nargs="?", default=96)
    ap.add_argument("--finetune", action="store_true")
    ap.add_argument("--scenes", type=int, default=160)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write the trained weights here (never the "
                         "checked-in file)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = workloads.open_device(args.device, "train_masknet")
    if dev is None:
        return 1
    res = run(args.steps, args.size, args.finetune, args.scenes, args.seed,
              dev, args.out, log=lambda s: print(s, flush=True))
    print("RESULT " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
