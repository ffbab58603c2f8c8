"""The readers of the program's own spans and counters
(``portbench/spans.py`` and the metrics that use it) on a traced run of
the small cells on the CPU: every such metric reads a value, the counts
agree with the replay's ``Diagnostics``, and a record whose frames do not
hold one ``substep`` span a substep reads nothing."""

import importlib

import pytest

from portbench import harness
from portbench.system import Program
from conftest import SMALL

READERS = {
    "small128.frames": ("sim_host_reads_per_frame", "host_read_wait_ms", "cg_iters_per_frame", "sort_host_ms",
                        "p2g_host_ms", "pressure_host_ms", "correction_host_ms", "collide_host_ms"),
    "small64.render": ("host_read_wait_ms.render",),
}


class ExtraSubstep(Program):
    """The program, with one more ``substep`` span in each frame than the
    frame has substeps."""

    def step(self, state, cfg, dt):
        profiling = importlib.import_module("libfluid_tpu_torch.profiling")
        out = super().step(state, cfg, dt)
        with profiling.span("substep"):  # joins the step's frame
            pass
        return out


@pytest.mark.parametrize("cell", [SMALL[c] for c in SMALL])
def test_every_reader_reads_a_value(tree, cell):
    result, _, _ = harness.run_cell(harness.Bench(tree), cell, 2**31 + 17, 0.0, True, device="cpu")
    metrics = result["metrics"]
    for name in READERS[cell]:
        assert name in metrics and metrics[name]["value"] >= 0.0, name
    if cell == "small128.frames":
        substeps = metrics["substeps_per_frame"]["value"]
        # a CFL read a substep and the last, and each solve's early-out and
        # loop tests, at the least
        assert metrics["sim_host_reads_per_frame"]["value"] >= 2 * substeps + 1
        assert metrics["cg_iters_per_frame"]["value"] > 0
        assert metrics["pressure_host_ms"]["value"] > 0


@pytest.mark.parametrize("cell", [SMALL[c] for c in SMALL])
def test_a_frame_with_a_stray_substep_reads_nothing(tree, cell):
    result, _, _ = harness.run_cell(harness.Bench(tree), cell, 2**31 + 19, 0.0, True, device="cpu",
                                    system=ExtraSubstep("cpu"))
    assert not set(READERS[cell]) & set(result["metrics"])
