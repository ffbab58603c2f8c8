"""On the card: one short run of each cell from the command line, with a
result line that the contract's reader takes and ``correct`` true. Skips
without a CUDA card."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

pytestmark = pytest.mark.card


@pytest.mark.parametrize("cell", ["dam64.render", "dam128.frames"])
@pytest.mark.parametrize("traced", [0, 1])
def test_a_short_run_is_correct(card, cell, traced):
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", "2718281828",
                           "--seconds", "2", "--trace", str(traced)], cwd=ROOT, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert result["correct"], proc.stderr[-4000:]
    assert result["failed"] == 0
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    if traced:
        assert result["device"]["busy_s"] > 0
    assert "setup_s" in result["metrics"] or traced
