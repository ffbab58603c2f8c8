"""Each cell's traffic at 16^3, a few frames through the port on the CPU
(its plain versions) and through the reference (the frozen copy of those
versions), compared by the numbers and limits that decide ``correct`` on
the card."""

import pytest

from portbench import harness
from conftest import SMALL


@pytest.mark.parametrize("cell", sorted(SMALL.values()))
def test_the_port_agrees_with_the_reference(tree, cell):
    result, checks, numbers = harness.run_cell(harness.Bench(tree), cell, 2**31 + 7, 0.0, False, device="cpu")
    assert checks and set(checks) <= set(numbers)
    assert result["correct"], checks
    assert result["failed"] == 0
