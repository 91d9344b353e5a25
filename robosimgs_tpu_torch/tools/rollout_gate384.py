"""The rollout frame's K 384 gate: camera 0 at K 384 (one tile chunk),
M 64 over an 84-tile bbox, against the lossless K 8,192 (tile_chunk
512) at the same M and bbox.

    python -m robosimgs_tpu_torch.tools.rollout_gate384 [--n 200000]
        [--width 640] [--height 480] [--device cuda]

A port of the JAX package's scripts/rollout_gate384.py, on
tools/profile_rollout.py's scene and gate. Prints the script's line,
`GATE K=384 (m=64) vs K=8192: <dB> dB`, then the truncated Gaussians
of both renders.
"""

from __future__ import annotations

import argparse
import sys

from robosimgs_tpu_torch.tools import profile_rollout as pr
from robosimgs_tpu_torch.tools import workloads


def gate384(g, cam) -> dict:
    """profile_rollout.gate of K 384 (tile_chunk 0) against K 8,192
    (tile_chunk 512), both at M 64 over an 84-tile bbox."""
    return pr.gate(g, cam, cands=((384, 0),), ref=(8192, 512))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    pr.add_scene_args(ap)
    args = ap.parse_args(argv)
    dev = workloads.open_device(args.device, "rollout_gate384")
    if dev is None:
        return 1
    g, cams, _ = pr.scene(dev, args.n, args.width, args.height)
    res = gate384(g, cams[0])
    print(f"GATE K=384 (m=64) vs K=8192: {res['gate_K384_dB']:.1f} dB",
          flush=True)
    print(f"truncated Gaussians {res['truncated']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
