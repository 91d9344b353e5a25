"""portbench's own tests: `python -m pytest portbench/tests`. They run
on the CPU, where the program's plain kernel versions stand in for the
CUDA ones."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
