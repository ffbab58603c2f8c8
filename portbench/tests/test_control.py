"""The control (``reference/control.py``: the reference with its state in
bfloat16, the next precision below the configurations' float32) in the
program's place comes out as not correct, at 16^3 on the CPU. On the card
``portbench/readings.py`` reads it at each cell's own size."""

import pytest

from portbench import harness
from portbench.reference.control import Control
from conftest import SMALL


@pytest.mark.parametrize("cell", sorted(SMALL.values()))
def test_the_control_is_not_correct(tree, cell):
    result, checks, _ = harness.run_cell(harness.Bench(tree), cell, 2**31 + 11, 0.0, False, device="cpu",
                                         control=Control("cpu"))
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in checks.values()), checks
