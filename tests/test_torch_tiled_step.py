"""``sim.step`` takes the slab-tiled substep (``bigstep.substep_tiled``) from
the grid size alone (``bigstep.slab_count``): the counts at the benchmark's
grids and at one whose nx is not a power of two; a small tide (a shallow
floor and a wall of water, 16^3, BASELINE config 5's two boxes scaled)
stepped over 4 slabs with the budget lowered, its spans and its counter,
and its frames against the benchmark's frozen plain reference
(``portbench/reference/lf``, plain PyTorch); the dense substep below the
budget and wherever autograd records through the state. Torch only, a few
seconds."""

import numpy as np
import pytest
import torch

from libfluid_tpu_torch import profiling, sim
from libfluid_tpu_torch.config import SimConfig, TransferScheme
from libfluid_tpu_torch.sim import bigstep
from portbench.hostcopy import to_host
from portbench.reference import state_io
from portbench.reference.lf import config as ref_config
from portbench.reference.lf.sim import step as ref_step

torch.set_num_threads(1)

FRAME = 1.0 / 60.0
# the tide's two boxes at 16^3: the floor, then the wall of water
BOXES = (((1.0, 1.0, 1.0), (14.0, 2.0, 14.0)), ((1.0, 3.0, 1.0), (3.0, 8.0, 14.0)))
STAGES = {"advect", "collide", "sort", "p2g", "pressure", "correction", "extrapolate", "g2p", "diagnostics"}


def _cfg(n):
    return SimConfig(grid_size=(n, n, n), gravity=(0.0, -981.0, 0.0), particle_capacity=1 << 13,
                     scheme=TransferScheme.APIC, has_obstacles=False)


def _tide(seed=2**31 + 5):
    cfg = _cfg(16)
    state = sim.new_state(cfg, "cpu", generator=seed)
    rng = np.random.default_rng(seed)
    for start, size in BOXES:
        state = sim.seed_box(state, cfg, start, size, rng=rng)
    return cfg, state


@pytest.fixture
def small_budget(monkeypatch):
    """Tile grids above 2^10 cells in slabs of at most 2^10: 4 slabs of 4
    layers at 16^3."""
    monkeypatch.setattr(bigstep, "_G2P_TILED_THRESHOLD", 1 << 10)
    monkeypatch.setattr(bigstep, "_SLAB_CELLS", 1 << 10)


@pytest.fixture
def no_tiling(monkeypatch):
    """``bigstep.substep_tiled`` replaced by a function that fails the test."""
    def called(*args, **kwargs):
        raise AssertionError("step took the slab-tiled substep")

    monkeypatch.setattr(bigstep, "substep_tiled", called)


@pytest.fixture
def record():
    profiling.clear()
    yield
    profiling.clear()


@pytest.mark.parametrize("n, slabs", [(64, 1), (128, 1), (256, 16), (192, 8)])
def test_slab_count_from_the_grid(n, slabs):
    """Dense up to 2^21 cells (the benchmark's 64^3 and 128^3 cells);
    BASELINE config 5's own 16 at 256^3; a divisor of nx = 192 whose slabs
    fit the budget where a power of two would not divide."""
    cfg = _cfg(n)
    assert bigstep.slab_count(cfg) == slabs
    if slabs > 1:
        assert n % slabs == 0 and n // slabs * n * n <= bigstep._SLAB_CELLS
        assert all(n // d * n * n > bigstep._SLAB_CELLS for d in range(1, slabs) if n % d == 0)


def test_a_tiled_step_records_its_stages_slabs_and_counter(small_budget, record):
    cfg, state = _tide()
    assert bigstep.slab_count(cfg) == 4
    state, _ = sim.step(state, cfg, FRAME)  # from rest a step takes one substep
    with profiling.tracing():
        state, diag = sim.step(state, cfg, 0.2)
    (frame,) = profiling.frames()
    nsub = int(diag.substeps)
    assert nsub >= 2 and len(frame.named("substep")) == nsub
    assert STAGES <= {s.name for s in frame.spans}
    assert frame.total("bigstep.slabs") == 4 * nsub
    slabs = frame.named("slab")
    assert len(slabs) == 2 * 4 * nsub
    assert sorted({s.parent.name for s in slabs}) == ["correction", "p2g"]
    # P2G's slab passes, the overflow merge, the springs' passes and the move
    assert len(frame.named("p2g")) == len(frame.named("correction")) == 5 * nsub
    assert int(diag.particle_count) == int(state.active.sum())


def test_tiled_frames_match_the_frozen_reference(small_budget):
    """Two frames of 1/60 s, each from the port's state before it, held to
    the reference's dense step from the same state and draws, row by row
    (both sort into the same rank-major order). The tolerances are those of
    ``test_torch_bigstep.py::_assert_matches_dense``, the tiled substep
    against the dense one: positions 5e-4 cells, well under the correction's
    move, as the springs and G2P see faces summed in another order; the
    velocities and faces 5e-3 and 2e-3, relative and absolute, the gap the
    pressure solve leaves from faces that differ in their last bits; the
    kinetic energy 1e-3 of itself, a sum over all particles."""
    cfg, state = _tide()
    rcfg = ref_config.SimConfig(grid_size=cfg.grid_size, gravity=cfg.gravity,
                                particle_capacity=cfg.particle_capacity, scheme=ref_config.TransferScheme.APIC,
                                has_obstacles=False)
    for _ in range(2):
        pre = state_io.from_host(to_host(state), "cpu")
        with profiling.tracing():
            profiling.clear()
            state, diag = sim.step(state, cfg, FRAME)
            assert profiling.frames()[-1].total("bigstep.slabs") == 4 * int(diag.substeps)
        profiling.clear()
        with torch.no_grad():
            ref, rdiag = ref_step.step(pre, rcfg, FRAME)
        assert int(diag.substeps) == int(rdiag.substeps)
        act = ref.active
        assert torch.equal(state.active, act)
        np.testing.assert_allclose(state.position[act].numpy(), ref.position[act].numpy(), rtol=0, atol=5e-4)
        np.testing.assert_allclose(state.velocity[act].numpy(), ref.velocity[act].numpy(), rtol=5e-3, atol=5e-3)
        for name in ("u", "v", "w"):
            np.testing.assert_allclose(getattr(state.grid, name).numpy(), getattr(ref.grid, name).numpy(),
                                       rtol=2e-3, atol=2e-3, err_msg=name)
        np.testing.assert_allclose(float(diag.kinetic_energy), float(rdiag.kinetic_energy), rtol=1e-3)
        assert float(rdiag.kinetic_energy) > 0


def test_below_the_budget_step_stays_dense(no_tiling, record):
    cfg, state = _tide()
    assert bigstep.slab_count(cfg) == 1
    with profiling.tracing():
        state, diag = sim.step(state, cfg, FRAME)
    (frame,) = profiling.frames()
    assert int(diag.substeps) >= 1 and len(frame.named("substep")) == int(diag.substeps)
    assert frame.total("bigstep.slabs") == 0 and not frame.named("slab")


def test_a_step_that_records_gradients_stays_dense(small_budget, no_tiling):
    """The tiled substep's gradients are held to nothing, so where autograd
    records through the state, ``step`` keeps the dense substep, whose
    gradients the tests hold to JAX's."""
    cfg, state = _tide()
    assert bigstep.slab_count(cfg) == 4
    state = state._replace(velocity=state.velocity.clone().requires_grad_())
    out, diag = sim.step(state, cfg, 1e-3)
    assert int(diag.substeps) == 1 and out.position.requires_grad
    with torch.no_grad(), pytest.raises(AssertionError, match="slab-tiled"):
        sim.step(state, cfg, 1e-3)
