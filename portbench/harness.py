"""Run one cell of BENCHMARK.json once: set-up, the measured window, the
profiled window (--trace 1), the check against the plain reference, and
the result line.

Everything a cell is made of is found by name: its configuration file
(BENCHMARK.json's `file`), its traffic mix (portbench/traffic/<traffic>
.json), the entry that the mix drives (portbench/entries/<entry>.py), the
limits of its check (portbench/limits/<cell>.json) and each metric's
reader (portbench/metrics/<metric>.py, or the family's
portbench/metrics/<the name before its first dot>.py where no file has
the whole name: one reader serves `mfu.train` and `mfu.frame`).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "robosimgs_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    bench: dict


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry_module(traffic: dict, base: Path = HERE):
    return load_module(base / "entries" / f"{traffic['entry']}.py",
                       f"portbench_entry_{traffic['entry']}")


def metric_reader(name: str, base: Path = HERE):
    """The reader of a metric: metrics/<name>.py, else the family's
    metrics/<name before the first dot>.py."""
    path = base / "metrics" / f"{name}.py"
    if not path.is_file():
        path = base / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path, f"portbench_metric_{name.replace('.', '_')}")


def resolve(bench: dict, workload: str, root: Path = ROOT) -> tuple:
    """(cell entry, configuration entry, configuration, traffic mix,
    limits) of a workload name, each file found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    c = {x["name"]: x for x in bench["configs"]}[w["config"]]
    with open(root / c["file"]) as fh:
        config = json.load(fh)
    base = root / "portbench"
    with open(base / "traffic" / f"{w['traffic']}.json") as fh:
        traffic = json.load(fh)
    with open(base / "limits" / f"{workload}.json") as fh:
        limits = json.load(fh)
    return w, c, config, traffic, limits


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of the workload reports: the end-to-end
    ones with --trace 0, the per-layer ones with --trace 1."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def missing_metrics(bench: dict, workload: str, trace: bool,
                    metrics: dict) -> list:
    """The metrics BENCHMARK.json lists for the run that it did not read:
    a reader that found nothing where the cell says there is something
    (a kernel renamed, an operation moved to another file)."""
    return [m["name"] for m in metrics_of(bench, workload, trace)
            if m["name"] not in metrics]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(device: str) -> dict:
    import torch
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def run_cell(cell: Cell, t_start: float) -> dict:
    """One run of the cell; returns the result line's object, the compared
    numbers ((name, value, limit, ok), ...) under "_checks" and, traced,
    the top attribution rows under "_rows"."""
    import torch
    on_card = torch.device(cell.device).type == "cuda"
    entry = entry_module(cell.traffic)
    state = entry.setup(cell)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    gc.collect()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    win = entry.window(state, cell.seconds)
    if on_card:
        torch.cuda.synchronize()
        win["peak_bytes"] = torch.cuda.max_memory_allocated()
    else:
        win["peak_bytes"] = 0
    after = getattr(entry, "after_window", None)
    if after is not None:
        after(state)
    traced = work = None
    if cell.trace:
        from portbench import tracing
        n_units, fn = entry.profile(state)
        with tracing.profiled(cell.device) as pw:
            fn()
        traced = tracing.reduce(pw, n_units, cell.device)
        work = entry.work(state)
    entry.release(state)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = entry.check(state)
    ctx = {"window": win, "setup_s": setup_s, "trace": traced, "work": work,
           "cell": cell}
    metrics = {}
    for m in metrics_of(cell.bench, cell.name, cell.trace):
        value = metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {**device_info(cell.device), "memory_peak_bytes": win["peak_bytes"]}
    out = {"correct": all(c[3] for c in checks),
           "attempted": win["attempted"], "failed": win["failed"],
           "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
        out["breakdown"] = traced["breakdown"]
        out["_rows"] = traced["rows"][:25]
    out["compared"] = {c[0]: {"value": c[1], "limit": c[2]} for c in checks}
    out["_checks"] = checks
    return out


def main(argv=None, t_start: float | None = None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench_path = ROOT / "BENCHMARK.json"
    if not (ROOT / "robosimgs_tpu_torch").is_dir() or not bench_path.is_file():
        print("portbench: the program (robosimgs_tpu_torch/) or "
              "BENCHMARK.json is not beside portbench/", file=sys.stderr)
        return 2
    with open(bench_path) as fh:
        bench = json.load(fh)
    w, _, config, traffic, limits = resolve(bench, args.workload)

    # every build and kernel cache inside the checkout, at fixed paths
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"portbench: {args.workload} needs {w['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # one process with few threads: the host is shared, and the frame
    # cells' host work (posing, copies) runs on torch's CPU threads
    torch.set_num_threads(min(4, torch.get_num_threads()))
    cell = Cell(name=args.workload, config=config, traffic=traffic,
                limits=limits, seed=args.seed, seconds=args.seconds,
                trace=bool(args.trace), device="cuda", bench=bench)
    out = run_cell(cell, t_start)
    missing = missing_metrics(bench, cell.name, cell.trace, out["metrics"])
    if missing:
        print(f"portbench: {', '.join(missing)} read nothing in "
              f"{args.workload}; no result", file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"portbench: {', '.join(found)} loaded in the process that "
              "reports; no result", file=sys.stderr)
        return 3
    checks = out.pop("_checks")
    for row in out.pop("_rows", []):
        print("device ms a unit: %8.4f %5.0f launches  %s  %s"
              % (row[3], row[2], row[0][:70], row[1][:50]), file=sys.stderr)
    for name, value, limit, ok in checks:
        print(f"{name} {value!r} limit {limit!r} {'ok' if ok else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0
