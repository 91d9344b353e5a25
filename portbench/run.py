"""The port's benchmark: run one cell of BENCHMARK.json once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics with --trace 0,
its per-layer metrics with --trace 1), device, with --trace 1 the
breakdown, and last the numbers compared with the reference beside their
limits (also the last lines of standard error). Exits non-zero, with no
result, without a CUDA device.
"""

import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench.harness import main
    sys.exit(main(t_start=T_START))
