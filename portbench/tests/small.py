"""Sizes a CPU test holds, put in place of the configurations' (the
capacities raised so that the small scenes never overflow a tile), and
shorter traffic."""

import json
import time

from portbench import harness

SMALL = {
    "staged1m": {"scene": {"n": 2000}, "cameras": {"width": 48,
                                                   "height": 48},
                 "render": {"binning": {"tile_capacity": 2048}}},
    "rollout200k": {"scene": {"n": 2000},
                    "cameras": {"width": 96, "height": 64},
                    "object": {"quads": 6, "episode": 3},
                    "render": {"binning": {"tile_capacity": 2048,
                                           "tile_chunk": 512}}},
}
TRAFFIC = {"episode": 8, "profile_steps": 2, "profile_frames": 2}


def merged(config: dict, over: dict) -> dict:
    """`config` with the nested entries of `over` put in its place."""
    out = dict(config)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) else v
    return out


def cell(name: str, seed: int = 2 ** 31 + 11, seconds: float = 0.5,
         trace: bool = False, root=harness.ROOT) -> harness.Cell:
    with open(root / "BENCHMARK.json") as fh:
        bench = json.load(fh)
    w, _, config, traffic, limits = harness.resolve(bench, name, root)
    config = merged(config, SMALL.get(w["config"], {}))
    traffic = {**traffic, **{k: v for k, v in TRAFFIC.items()
                             if k in traffic}}
    return harness.Cell(name=name, config=config, traffic=traffic,
                        limits=limits, seed=seed, seconds=seconds,
                        trace=trace, device="cpu", bench=bench)


def run(c: harness.Cell) -> dict:
    return harness.run_cell(c, time.perf_counter())
