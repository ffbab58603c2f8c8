"""The small copy of ``tide256.frames`` (16^3, on the CPU) with the port's
slab budget lowered, so that ``sim.step`` tiles every substep over 4 x-slabs
as it tiles the 256^3 tide over 16: a traced run is correct, its spans are
read by ``portbench/spans.py`` (the span readers the cell lists and
``slab_host_ms``), a record with a stray ``substep`` span reads nothing,
and a run of the dense substep reads no slab metric."""

import importlib

import pytest

from portbench import harness
from conftest import SMALL
from test_spans import ExtraSubstep

CELL = SMALL["tide256.frames"]
SPAN_READERS = ("sim_host_reads_per_frame", "host_read_wait_ms", "cg_iters_per_frame", "sort_host_ms",
                "p2g_host_ms", "pressure_host_ms", "correction_host_ms", "collide_host_ms", "slab_host_ms")


@pytest.fixture
def tiled(monkeypatch):
    """4 slabs of 4 x-layers at 16^3."""
    bigstep = importlib.import_module("libfluid_tpu_torch.sim.bigstep")
    monkeypatch.setattr(bigstep, "_G2P_TILED_THRESHOLD", 1 << 10)
    monkeypatch.setattr(bigstep, "_SLAB_CELLS", 1 << 10)
    return bigstep


def _cfg(tree):
    """The small copy's ``SimConfig``."""
    from portbench.system import Program

    bench = harness.Bench(tree)
    return Program("cpu").sim_config(bench.config(bench.cell(CELL)["config"]))


def test_a_traced_tiled_run_reads_its_spans(tree, tiled):
    profiling = importlib.import_module("libfluid_tpu_torch.profiling")
    assert tiled.slab_count(_cfg(tree)) == 4
    result, checks, _ = harness.run_cell(harness.Bench(tree), CELL, 2**31 + 29, 0.0, True, device="cpu")
    assert result["correct"], checks
    assert result["failed"] == 0
    metrics = result["metrics"]
    for name in SPAN_READERS:
        assert name in metrics and metrics[name]["value"] > 0.0, name
    assert "slab_device_ms" not in metrics  # no device: the trace places no kernel
    # the replayed frames: 4 slabs a substep, a slab span for each pass
    frame = profiling.frames()[-1]
    substeps = len(frame.named("substep"))
    assert substeps >= 1 and frame.total("bigstep.slabs") == 4 * substeps
    assert len(frame.named("slab")) == 2 * 4 * substeps


def test_a_dense_run_reads_no_slab_metric(tree):
    result, _, _ = harness.run_cell(harness.Bench(tree), CELL, 2**31 + 31, 0.0, True, device="cpu")
    assert result["correct"]
    assert "p2g_host_ms" in result["metrics"]
    assert not {"slab_host_ms", "slab_device_ms"} & set(result["metrics"])


def test_a_tiled_frame_with_a_stray_substep_reads_nothing(tree, tiled):
    result, _, _ = harness.run_cell(harness.Bench(tree), CELL, 2**31 + 37, 0.0, True, device="cpu",
                                    system=ExtraSubstep("cpu"))
    assert not set(SPAN_READERS) & set(result["metrics"])
