"""The closed loop that frame cells drive: one caller, the next call as
soon as the previous one returns, the calls' keys in turn (views, or the
timesteps of an episode), for a fixed number of seconds.

Each call is timed from the moment it is made to its return. A sample of
the keys, drawn from the seed before the window, keeps one returned
answer each (a reservoir of one over that key's returns, drawn from the
seed), for the check after the window.
"""

from __future__ import annotations

import time

import numpy as np


def sample_keys(seed: int, n_keys: int, k: int) -> list:
    rng = np.random.default_rng(seed)
    return sorted(int(x) for x in rng.choice(n_keys, size=min(k, n_keys),
                                             replace=False))


def closed_loop(call, n_keys: int, seconds: float, keys: list,
                seed: int) -> dict:
    """call(key) -> answer (host arrays). Returns {"units", "wall_s",
    "latencies_s", "kept": {key: answer}}."""
    rng = np.random.default_rng(seed + 1)
    seen = {k: 0 for k in keys}
    kept = {}
    lat = []
    i = 0
    t0 = time.perf_counter()
    while True:
        key = i % n_keys
        t1 = time.perf_counter()
        ans = call(key)
        lat.append(time.perf_counter() - t1)
        if key in seen:
            seen[key] += 1
            if rng.integers(seen[key]) == 0:
                kept[key] = ans
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    return {"units": i, "wall_s": time.perf_counter() - t0,
            "latencies_s": lat, "kept": kept}
