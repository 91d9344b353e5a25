"""utils/profiling.py and utils/debug.py of the port: the stage timer,
the JSONL metrics logger, a trace written to a file, and the NaN/Inf
sanitizers on the cases of tests/test_utils.py::test_checked_catches_nan."""

import dataclasses
import json

import jax  # noqa: F401  (tests import both packages)
import numpy as np
import pytest
import torch

from robosimgs_tpu_torch.utils.debug import assert_finite, checked
from robosimgs_tpu_torch.utils.profiling import (MetricsLogger, StageTimer,
                                                 trace)


def test_stage_timer_counts_and_averages():
    t = StageTimer()
    for _ in range(3):
        with t.stage("matmul", sync_on=torch.ones(4) @ torch.ones(4)):
            pass
    with t.stage("other"):
        pass
    s = t.summary()
    assert set(s) == {"matmul", "other"} and t.counts["matmul"] == 3
    assert all(v >= 0.0 for v in s.values())
    assert t.device_ms() == {}          # nothing ran on a card
    assert "matmul" in t.report() and "x3" in t.report()


def test_metrics_logger_writes_jsonl(tmp_path):
    path = tmp_path / "logs" / "metrics.jsonl"
    log = MetricsLogger(str(path))
    row = log.log(0, loss=torch.tensor(0.5), psnr=np.float32(20.0))
    log.log(1, loss=0.25)
    assert row["step"] == 0 and row["loss"] == 0.5 and row["psnr"] == 20.0
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["step"] for r in lines] == [0, 1] == [r["step"] for r in log.rows]
    assert lines[1]["loss"] == 0.25 and "time" in lines[1]
    assert MetricsLogger().log(2, a=1)["a"] == 1.0   # no file


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
