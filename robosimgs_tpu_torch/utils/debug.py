"""Numerical sanitizers: the port of robosimgs_tpu/utils/debug.py.

  checked(fn)        — wraps fn so a NaN or Inf in any floating tensor of
                       its output raises, naming where (the JAX
                       package's checkify wrapper)
  assert_finite(x)   — host-side finiteness assert over nested dicts,
                       lists, tuples, dataclasses and tensors or arrays
  plain versions     — each CUDA kernel's plain torch version
                       (render/kernels.py) runs its arithmetic on the CPU,
                       the counterpart of the Pallas kernels' interpret
                       mode
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List

import numpy as np
import torch


def _walk(x, path: str, visit) -> None:
    if isinstance(x, (torch.Tensor, np.ndarray)):
        visit(path, x)
    elif isinstance(x, dict):
        for k, v in x.items():
            _walk(v, f"{path}[{k!r}]", visit)
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _walk(v, f"{path}[{i}]", visit)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _walk(getattr(x, f.name), f"{path}.{f.name}", visit)


def _non_finite(tree, name: str) -> List[str]:
    """'<path>: <n> non-finite' for each floating tensor or array of tree
    that holds a NaN or an Inf. Reads the values, so it waits for the
    device."""
    bad = []

    def visit(path, x):
        if isinstance(x, torch.Tensor):
            if x.is_floating_point() or x.is_complex():
                n = int((~torch.isfinite(x)).sum())
                if n:
                    bad.append(f"{path}: {n} non-finite")
        elif x.dtype.kind in "fc":
            n = int(np.size(x) - np.isfinite(x).sum())
            if n:
                bad.append(f"{path}: {n} non-finite")

    _walk(tree, name, visit)
    return bad


def checked(fn: Callable, enabled: bool = True) -> Callable:
    """Wrap fn so a NaN or Inf in any floating tensor of its output
    raises a FloatingPointError naming the output and the count ("nan
    or inf"). With enabled=False the wrapper returns fn's output
    untouched and waits for nothing; enabled, the check reads every
    output, which waits for the device."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        if enabled:
            bad = _non_finite(out, getattr(fn, "__name__", "fn"))
            if bad:
                raise FloatingPointError("nan or inf in the output of "
                                         + "; ".join(bad))
        return out

    return wrapper


def assert_finite(tree, name: str = "tree") -> None:
    """Host-side finiteness assert over a nested structure of tensors or
    arrays (dicts, lists, tuples, dataclasses) for tests and CLIs."""
    bad = _non_finite(tree, name)
    if bad:
        raise AssertionError("; ".join(bad))
