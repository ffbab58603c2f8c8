"""The port's profiling utilities (``libfluid_tpu_torch.profiling``) on the
CPU: ``sync`` of nested tensors, ``timeit``'s seconds and output,
``StageTimer`` (the host's clock on the CPU; CUDA events on the card) with
its totals, counts and report, and ``trace`` writing a Chrome trace."""

import json
import os
import time

import pytest
import torch

from libfluid_tpu_torch import profiling

torch.set_num_threads(1)


def test_sync_and_timeit():
    profiling.sync({"a": (torch.zeros(3), [torch.ones(2)]), "b": None})
    calls = []

    def f(x):
        calls.append(1)
        return x * 2

    sec, out = profiling.timeit(f, torch.arange(4.0), iters=3, warmup=2)
    assert sec >= 0.0 and torch.equal(out, torch.arange(4.0) * 2) and len(calls) == 5


def test_stage_timer_on_the_cpu():
    timer = profiling.StageTimer("cpu")
    for _ in range(2):
        with timer.stage("sleep"):
            time.sleep(0.01)
        with timer.stage("add"):
            torch.ones(2) + 1
    totals = timer.totals
    assert totals["sleep"] >= 0.02 and timer.counts == {"sleep": 2, "add": 2}
    lines = timer.report().splitlines()
    assert lines[0].startswith("sleep") and "x2" in lines[0] and len(lines) == 2


def test_stage_timer_defaults_to_the_card():
    """Like every constructor of the port, the timer takes the card unless
    asked for the CPU; without a card ``device=None`` raises instead of
    timing CPU work as if it ran there."""
    if torch.cuda.is_available():
        assert profiling.StageTimer().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device=None"):
            profiling.StageTimer()
    assert profiling.StageTimer("cpu").device.type == "cpu"


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(64) @ torch.ones(64)
    path = os.path.join(tmp_path, "trace.json")
    assert json.load(open(path))["traceEvents"]
