"""The port's profiling utilities (``libfluid_tpu_torch.profiling``) on the
CPU: ``sync`` of nested tensors, ``timeit``'s seconds and output,
``StageTimer`` (the host's clock on the CPU; CUDA events on the card) with
its totals, counts and report, ``trace`` writing a Chrome trace, and the
record of spans and counters: nesting, frames and self time, nothing
recorded while off, the spans as ``user_annotation`` events of a profiler's
trace, the counts of a 16^3 dam-break's reads and CG iterations, the
renderer's ``loops.HOST_READS``, the cost of a span while off, and the P2G
overflow merge of the slab-tiled and z-sharded substeps."""

import json
import os
import time

import pytest
import torch

from libfluid_tpu_torch import convert, profiling
from libfluid_tpu_torch import sim
from libfluid_tpu_torch.config import MesherConfig, SimConfig, TransferScheme
from libfluid_tpu_torch.mesher.marching_cubes import generate_mesh
from libfluid_tpu_torch.renderer import loops
from libfluid_tpu_torch.sim import bigstep
import torch_ranks

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


@pytest.fixture
def record():
    """An empty record, emptied again after the test."""
    profiling.clear()
    yield
    profiling.clear()


def test_spans_nest_with_their_parents_frames_and_self_time(record):
    with profiling.tracing():
        with profiling.span("step"):
            with profiling.span("substep"):
                with profiling.span("sort"):
                    time.sleep(0.002)
                profiling.count("k", 2)
                with profiling.span("pressure"):
                    profiling.count("k")
                    time.sleep(0.002)
        with profiling.span("mesh"):  # joins the step's frame
            with profiling.span("mesh"):  # one span with its namesake
                pass
        with profiling.span("step"):
            pass
    frames = profiling.frames()
    assert [[s.name for s in f.spans] for f in frames] == [["step", "substep", "sort", "pressure", "mesh"],
                                                            ["step"]]
    step, substep, sort, pressure, mesh = frames[0].spans
    assert (step.parent, substep.parent, sort.parent, pressure.parent, mesh.parent) == (
        None, step, substep, substep, None)
    assert [s.depth for s in frames[0].spans] == [0, 1, 2, 2, 0]
    assert {s.frame for s in frames[0].spans} == {frames[0].id} and frames[1].id != frames[0].id
    assert substep.counters == {"k": 2} and pressure.counters == {"k": 1} and frames[0].total("k") == 3
    assert substep.self_ns == substep.ns - sort.ns - pressure.ns
    assert step.self_ns == step.ns - substep.ns and sort.self_ns == sort.ns >= 2_000_000
    assert [s.name for s in frames[0].below("substep")] == ["substep", "sort", "pressure"]
    profiling.clear()
    assert profiling.frames() == []


def test_off_records_nothing_and_opens_no_record_function(record, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened while off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    first, second = profiling.span("step"), profiling.span("sort")
    assert first is second  # one shared no-op context
    with profiling.span("step"):
        profiling.count("cg_iterations", 3)
        assert profiling.read(torch.tensor(2.5), "site") == 2.5
        with profiling.blocking("site"):
            torch.nonzero(torch.ones(3))
    assert profiling.frames() == []
    with profiling.tracing():  # no profiler records: no range either
        with profiling.span("step"):
            pass
    assert [s.name for f in profiling.frames() for s in f.spans] == ["step"]


def _dam_break(n=16, **kwargs):
    """The 16^3 dam-break of the substep tests, in the port alone, thrown
    at 60 cells/s so that a step of 0.1 s takes several CFL substeps."""
    kwargs = dict(dict(enable_position_correction=False, has_obstacles=False), **kwargs)
    cfg = SimConfig(grid_size=(n, n, n), cell_size=1.0, grid_offset=(0.0, 0.0, 0.0), gravity=(0.0, -10.0, 0.0),
                    particle_capacity=1 << 13, scheme=TransferScheme.APIC, **kwargs)
    state = sim.new_state(cfg, "cpu")
    return cfg, sim.seed_box(state, cfg, (0.5, 0.5, 0.5), (n / 2.0, n / 2.0, n / 2.0), velocity=(45.0, -40.0, 0.0))


def test_a_profiler_trace_holds_the_spans(record, tmp_path):
    cfg, state = _dam_break(enable_position_correction=True)
    with profiling.trace(str(tmp_path)):
        sim.step(state, cfg, 0.05)
    events = json.load(open(os.path.join(tmp_path, "trace.json")))["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"step", "substep", "advect", "collide", "sort", "p2g", "pressure", "correction", "extrapolate", "g2p",
            "diagnostics"} <= names
    frames = profiling.frames()
    assert len(frames) == 1 and frames[0].spans[0].name == "step"


def test_a_step_counts_its_cfl_and_cg_reads(record):
    cfg, state = _dam_break()
    with profiling.tracing():
        state, diag = sim.step(state, cfg, 0.1)
    (frame,) = profiling.frames()
    (step,) = frame.named("step")
    nsub = int(diag.substeps)
    assert nsub >= 2 and len(frame.named("substep")) == nsub
    assert step.counters["reads.step.cfl"] == nsub + 1
    for p in frame.named("pressure"):
        assert p.counters["reads.cg.early_out"] == 1
        assert p.counters["reads.cg.loop"] == p.counters["cg_iterations"] + 1
    reads = sum(v for s in frame.spans for k, v in s.counters.items() if k.startswith("reads."))
    assert frame.total("reads") == reads == frame.total("reads", under="step")
    assert frame.total("read_wait_ns") > 0


def test_cg_iterations_are_every_substeps(record):
    cfg, state = _dam_break()
    generator = state.generator.get_state()
    with profiling.tracing():
        sim.step(state, cfg, 0.1)
    (frame,) = profiling.frames()
    # the same substeps, one at a time, as step runs them
    state.generator.set_state(generator)
    remaining, iterations = torch.tensor(0.1), []
    while bool(remaining > 0.0):
        ts = torch.minimum(cfg.cfl_number * sim.cfl_dt(state, cfg), remaining)
        state, diag = sim.substep(state, cfg, ts)
        remaining = remaining - ts
        iterations.append(int(diag.pressure_iterations))
    assert len(iterations) >= 2 and frame.total("cg_iterations") == sum(iterations)
    assert [s.counters["cg_iterations"] for s in frame.named("pressure")] == iterations


def test_obstacles_count_the_march_and_the_mesh_its_stages(record):
    cfg, state = _dam_break(has_obstacles=True)
    solid = torch.zeros(cfg.grid_size, dtype=torch.bool)
    solid[6:10, 0:3, 6:10] = True
    state = sim.state.set_solid(state, solid)
    mcfg = MesherConfig(grid_size=(16, 16, 16), cell_size=1.0, max_triangles=1 << 13)
    with profiling.tracing():
        state, _ = sim.step(state, cfg, 0.05)
        mesh = generate_mesh(state.position, state.active, mcfg)
    (frame,) = profiling.frames()
    collides = frame.named("collide")
    assert len(collides) == 2 * len(frame.named("substep"))
    assert all(c.counters.get("reads.collisions.march", 0) >= 1 for c in collides)
    assert [s.name for s in frame.below("mesh")] == ["mesh", "surface", "marching_cubes"]
    (mc,) = frame.named("marching_cubes")
    assert mc.counters["reads.marching_cubes.nonzero"] >= 1 and int(mesh.count) > 0
    assert frame.named("sort")[0].counters["reads.sort.bincount"] == 1


def test_loops_host_reads_count_as_before(record):
    loops.reset_host_reads()
    assert loops.flag(torch.tensor(True)) is True and loops.flag(torch.tensor(False)) is False
    assert loops.HOST_READS["count"] == 2
    with profiling.tracing(), profiling.span("render"):
        loops.flag(torch.tensor(True), "pathtrace.persistent")
    assert loops.HOST_READS["count"] == 3
    (frame,) = profiling.frames()
    assert frame.spans[0].counters["reads.pathtrace.persistent"] == 1


def test_stage_timer_stages_are_spans(record):
    timer = profiling.StageTimer("cpu")
    with profiling.tracing():
        with timer.stage("sort"):
            pass
    assert timer.counts == {"sort": 1}
    assert [s.name for f in profiling.frames() for s in f.spans] == ["sort"]


def test_a_span_costs_little_while_off(record):
    """Off, a span is a flag test and a shared no-op context. 5 us a span
    is far above what it takes (tenths of a microsecond), so the test holds
    on a loaded worker too."""
    n = 20000
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            with profiling.span("substep"):
                profiling.count("cg_iterations", 1)
        best = min(best, (time.perf_counter() - t0) / n)
    assert best < 5e-6 and profiling.frames() == []


@pytest.mark.parametrize("path", ["tiled", "zshard"])
def test_tiled_and_sharded_substeps_merge_p2g_overflow_once(record, path, tmp_path):
    """The slab-tiled substep and the z-sharded one (one gloo rank) merge
    P2G's slot-overflow rows through ``transfers.p2g_merge_overflow``: one
    ``p2g_overflow.plain`` a substep, its window's rows not all empty, on
    two interleaved seedings (16 particles a cell, past 12 slots)."""
    cfg = SimConfig(grid_size=(16, 16, 16), particle_capacity=1 << 13, gravity=(0.0, -981.0, 0.0),
                    scheme=TransferScheme.APIC, has_obstacles=False)
    state = sim.new_state(cfg, device="cpu")
    for start, size in (((1.0, 1.0, 1.0), (6.0, 6.0, 6.0)), ((1.2, 1.2, 1.2), (6.2, 6.2, 6.2))):
        state = sim.seed_box(state, cfg, start, size)
    if path == "tiled":
        got = torch_ranks.overflow_merges(lambda s: bigstep.substep_tiled(s, cfg, 0.01, 2), state, 2)
    else:
        payload = dict(cfg=cfg, arrays=convert.state_to_numpy(state), dt=0.01, steps=2)
        got = torch_ranks.run(1, "substeps_z_overflow", payload, tmp_path)[0]
    for sub in got:
        assert sub["count"] == len(sub["rows"]) == 1
        assert sub["overflow"] > 0 and sub["rows"][0] > 0
