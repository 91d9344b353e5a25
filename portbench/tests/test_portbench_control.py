"""The control: the plain reference in the program's place with its
products computed in TF32 (the precision below the configurations'
float32 with TF32 off), fails each cell's check, where the program passes
it. `portbench/control.py` reads the same numbers on the card at the
cells' own sizes on many seeds; here at a size a test run holds (the
reference rounds each product's operands to TF32 itself, so the control
exists on the CPU too)."""

import pytest

from portbench import checks, control, harness
from portbench.tests import small


@pytest.mark.parametrize("name", ["staged1m-train", "staged1m-views",
                                  "rollout200k-mesh", "rollout200k-splats"])
def test_the_control_fails_where_the_program_passes(name):
    c = small.cell(name)
    r = control.readings(c, harness.entry_module(c.traffic), 2 ** 31 + 7,
                         True)
    assert all(ok for *_, ok in checks.judged(c.limits, r["program"]))
    assert not all(ok for *_, ok in checks.judged(c.limits, r["control"]))
    if "half_batch" in r:
        assert not all(ok for *_, ok in checks.judged(c.limits,
                                                      r["half_batch"]))
