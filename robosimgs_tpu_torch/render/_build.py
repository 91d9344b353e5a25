"""Build the port's CUDA sources (csrc/*.cu) at first use.

Each source is compiled by nvcc for Hopper (sm_90a) into a shared
library with a plain C interface, loaded with ctypes. Libraries go to
build/kernels/ at the repository root, named by a hash of the source
and the flags, so an edited source rebuilds and an unchanged one is
reused. A missing nvcc or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class Built:
    path: Path
    seconds: float    # compile time; 0 when the library was already built
    ptxas: str        # nvcc -Xptxas -v report (registers, smem, spills)


def find_nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def _library(name: str) -> Path:
    """Where csrc/<name>.cu's library goes: keyed by the source, the
    headers it may include and the flags."""
    key = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def build_all(names) -> dict[str, Built]:
    """Compile csrc/<name>.cu for each name whose library is not built
    yet, one nvcc per source, all started together."""
    out, jobs = {}, {}
    for name in names:
        so = _library(name)
        if so.is_file():
            out[name] = Built(so, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (so, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (so, tmp, t0, proc) in jobs.items():
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed with code {proc.returncode} on "
                          f"{name}.cu:\n{stdout}{stderr}")
            continue
        os.replace(tmp, so)   # atomic: a concurrent build never sees a partial file
        ptxas = " | ".join(line.strip() for line in stderr.splitlines()
                           if "ptxas" in line or "spill" in line)
        print(f"built {so.name} in {seconds:.1f} s: {ptxas}", file=sys.stderr)
        out[name] = Built(so, seconds, ptxas)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str) -> Built:
    """Compile csrc/<name>.cu unless its library is already built."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build(name).path))
    return lib
