"""The readings that a cell's limits are set from, on many seeds in one
process: the program's numbers (the lower reading: the largest over the
seeds) and the control's (the upper reading: the smallest), where the
control is the plain reference put in the program's place and computed
in the precision below the configuration's: TF32 matmuls and
convolutions for float32 with TF32 off. For training also the planted
fault of half the batch left out (the loss over the upper half of the
image's rows), read from the reference put in the program's place.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ...
        [--control-seeds 1 2 3] [--out readings.json]

Each seed's program numbers come from the entry's own set-up (training:
the checked steps through Trainer.run) or from one call of the entry per
checked key (frame cells), exactly as a run compares them. Prints one
JSON line per seed and a summary. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def readings(cell, entry, seed: int, control: bool) -> dict:
    """One seed's numbers, as the entry's `readings` gives them."""
    cell.seed = seed
    return {"seed": seed, **entry.readings(entry.setup(cell), control)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    with open(harness.ROOT / "BENCHMARK.json") as fh:
        bench = json.load(fh)
    w, _, config, traffic, limits = harness.resolve(bench, args.workload)
    cell = harness.Cell(name=args.workload, config=config, traffic=traffic,
                        limits=limits, seed=0, seconds=0.0, trace=False,
                        device="cuda", bench=bench)
    entry = harness.entry_module(traffic)
    ctl = set(args.seeds if args.control_seeds is None
              else args.control_seeds)
    rows = []
    for s in args.seeds:
        t0 = time.perf_counter()
        r = readings(cell, entry, s, s in ctl)
        r["seconds"] = time.perf_counter() - t0
        rows.append(r)
        print(json.dumps(r), flush=True)
    summary = {"workload": args.workload,
               "device": torch.cuda.get_device_name(0), "lower": {},
               "upper": {}}
    for name in rows[0]["program"]:
        summary["lower"][name] = max(r["program"][name] for r in rows)
        for kind in ("control", "half_batch"):
            vals = [r[kind][name] for r in rows if kind in r]
            if vals:
                summary["upper"].setdefault(kind, {})[name] = min(vals)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"rows": rows, "summary": summary}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
