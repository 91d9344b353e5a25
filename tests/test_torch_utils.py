"""utils/profiling.py and utils/debug.py of the port: a trace written to
a file (the span recorder: tests/test_torch_spans.py), and the NaN/Inf
sanitizers on the cases of tests/test_utils.py::test_checked_catches_nan."""

import dataclasses
import json

import jax  # noqa: F401  (tests import both packages)
import numpy as np
import pytest
import torch

from robosimgs_tpu_torch.utils.debug import assert_finite, checked
from robosimgs_tpu_torch.utils.profiling import trace


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    data = json.loads(open(prof.trace_path).read())
    assert prof.trace_path.startswith(str(tmp_path / "tr"))
    assert any("mm" in e.get("name", "") for e in data["traceEvents"])


@dataclasses.dataclass
class _Pair:
    a: torch.Tensor
    b: np.ndarray


def test_checked_catches_nan():
    f = checked(torch.log)      # nan for a negative input
    assert np.isfinite(float(f(torch.tensor(2.0))))
    with pytest.raises(FloatingPointError, match="nan"):
        f(torch.tensor(-1.0))
    with pytest.raises(FloatingPointError, match="inf"):
        checked(lambda x: {"y": [x / 0.0]})(torch.ones(2))
    # disabled: the output comes back untouched, no check
    assert torch.isnan(checked(torch.log, enabled=False)(torch.tensor(-1.0)))
    # integer outputs are not checked
    assert checked(lambda: torch.arange(3))().tolist() == [0, 1, 2]

    assert_finite({"a": torch.ones(3)})
    with pytest.raises(AssertionError, match="non-finite"):
        assert_finite({"a": torch.tensor([1.0, np.nan])})
    with pytest.raises(AssertionError, match=r"x\.b: 1 non-finite"):
        assert_finite(_Pair(torch.zeros(2), np.array([np.inf, 0.0])), "x")
    assert_finite([torch.ones(2), (np.zeros(3), 4)])
