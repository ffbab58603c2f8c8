"""Parity of the PyTorch port's substep and CFL step with the JAX package, on
the small dam-break scenes of ``test_sim_e2e.py`` (position correction off,
then on with exactly coincident particles), a 16^3 scene with a solid block
and a source, and per-step source seeding. Both packages start from the same
seeded state (carried over with ``libfluid_tpu_torch.convert``); the port
runs its plain PyTorch versions of the kernels here (CPU tensors) and takes
the JAX package's random draws (:class:`JaxDraws`)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu.config import SimConfig, TransferScheme
from libfluid_tpu.sim import new_state, seed_box, seed_sphere, step, substep
from libfluid_tpu.sim.state import set_solid
from libfluid_tpu.sim import jitterhash
from libfluid_tpu.sim import sources as sources_mod
from libfluid_tpu_torch import convert
from libfluid_tpu_torch.sim import sources as t_sources
from libfluid_tpu_torch.sim import state as t_state
from libfluid_tpu_torch import sim as t_sim

torch.set_num_threads(1)


def _dam_break(n, scheme=TransferScheme.APIC):
    """test_sim_e2e._dam_break with correction off and no obstacles (the
    port's collision pass is the obstacle-free one; with no solid cells
    both branches of the JAX pass give the same positions). The 16^3 box
    seeds 4109 particles, so it gets twice the capacity."""
    cfg = SimConfig(
        grid_size=(n, n, n),
        cell_size=1.0,
        grid_offset=(0.0, 0.0, 0.0),
        gravity=(0.0, -10.0, 0.0),
        particle_capacity=1 << 12 if n <= 12 else 1 << 13,
        scheme=scheme,
        enable_position_correction=False,
        has_obstacles=False,
    )
    state = new_state(cfg, jax.random.PRNGKey(0))
    state = seed_box(state, cfg, (0.5, 0.5, 0.5), (n / 2.0, n / 2.0, n / 2.0))
    return cfg, state


@functools.lru_cache(maxsize=None)
def _jax_substep(cfg, dt):
    return jax.jit(lambda s: substep(s, cfg, dt))


def _state_arrays(state):
    s = jax.tree_util.tree_map(np.asarray, state)
    return dict(
        position=s.position, velocity=s.velocity, affine=s.affine,
        active=s.active, u=s.grid.u, v=s.grid.v, w=s.grid.w,
        cell_type=s.grid.cell_type, solid=s.solid, pressure=s.pressure,
        time=s.time,
    )


def _port(cfg, state):
    tcfg = convert.config_from_fields(**vars(cfg))
    return tcfg, convert.state_from_numpy(_state_arrays(state), tcfg, "cpu")


def _compare(j_state, t_state, pos_atol):
    a = _state_arrays(j_state)
    b = convert.state_to_numpy(t_state)
    np.testing.assert_array_equal(a["active"], b["active"])
    np.testing.assert_allclose(b["position"], a["position"], rtol=0, atol=pos_atol)
    return a, b


@pytest.mark.parametrize(
    "n,scheme",
    [(12, TransferScheme.APIC), (16, TransferScheme.APIC), (12, TransferScheme.PIC),
     (12, TransferScheme.FLIP)],
)
def test_substep_matches_jax(n, scheme):
    cfg, state = _dam_break(n, scheme)
    tcfg, tstate = _port(cfg, state)

    j_state, j_diag = _jax_substep(cfg, 0.05)(state)
    t_state, t_diag = t_sim.substep(tstate, tcfg, 0.05)

    a, b = _compare(j_state, t_state, pos_atol=1e-4)
    for key in ("velocity", "affine"):
        scale = float(np.max(np.abs(a[key]))) + 1e-12
        np.testing.assert_allclose(b[key], a[key], rtol=0, atol=1e-3 * scale)
    assert int(t_diag.particle_count) == int(j_diag.particle_count)
    assert int(t_diag.overflow_count) == int(j_diag.overflow_count)
    assert abs(int(t_diag.pressure_iterations) - int(j_diag.pressure_iterations)) <= 1
    for key in ("kinetic_energy", "potential_energy"):
        np.testing.assert_allclose(
            float(getattr(t_diag, key)), float(getattr(j_diag, key)), rtol=1e-4
        )
    assert float(t_diag.pressure_residual) < cfg.solver.tolerance
    np.testing.assert_allclose(float(t_diag.max_divergence), float(j_diag.max_divergence), atol=1e-4)


def test_cfl_step_matches_jax():
    cfg, state = _dam_break(12)
    tcfg, tstate = _port(cfg, state)
    # one step to get the fluid moving, then the compared CFL step
    state, _ = _jax_substep(cfg, 0.05)(state)
    tstate, _ = t_sim.substep(tstate, tcfg, 0.05)

    j_state, j_diag = jax.jit(lambda s: step(s, cfg, 0.05))(state)
    t_state, t_diag = t_sim.step(tstate, tcfg, 0.05)

    assert int(t_diag.substeps) == int(j_diag.substeps)
    _compare(j_state, t_state, pos_atol=1e-3)


def test_coerce_velocities_matches_jax():
    cfg, state = _dam_break(12)
    rng = np.random.default_rng(3)
    state = state._replace(
        velocity=jnp.asarray(rng.normal(size=state.velocity.shape), jnp.float32),
        affine=jnp.asarray(rng.normal(size=state.affine.shape), jnp.float32),
    )
    src = sources_mod.make_source_set(
        cells=[[2, 2, 2], [3, 1, 4], [2, 2, 2]],
        velocity=[[0.0, -2.0, 0.0], [1.0, 0.0, 0.0], [5.0, 5.0, 5.0]],
        coerce_velocity=True,
    )
    want = sources_mod.coerce_velocities(state._replace(sources=src), cfg)

    tcfg, tstate = _port(cfg, state)
    tsrc = type(tstate.sources)(*(torch.as_tensor(np.array(a)) for a in src))
    got = t_sources.coerce_velocities(tstate._replace(sources=tsrc), tcfg)
    np.testing.assert_array_equal(got.velocity.numpy(), np.asarray(want.velocity))
    np.testing.assert_array_equal(got.affine.numpy(), np.asarray(want.affine))
    # a state with sources runs the substep, seeding from its generator
    n0 = int(tstate.active.sum())
    _, diag = t_sim.substep(tstate._replace(sources=tsrc), tcfg, 0.05)
    assert int(diag.particle_count) > n0


def test_convert_round_trip():
    cfg, state = _dam_break(12)
    tcfg, tstate = _port(cfg, state)
    assert dataclasses.asdict(tcfg)["solver"] == dataclasses.asdict(cfg)["solver"]
    assert tcfg.scheme.value == cfg.scheme.value and tcfg.dtype == torch.float32
    a = _state_arrays(state)
    b = convert.state_to_numpy(tstate)
    for key in convert.STATE_KEYS:
        np.testing.assert_array_equal(b[key], a[key])


def test_seeding_and_solid_equal_jax():
    """Host seeding draws the same numbers in both packages; set_solid marks
    the same cells."""
    cfg, _ = _dam_break(12)
    tcfg = convert.config_from_fields(**vars(cfg))
    jst = seed_sphere(new_state(cfg, jax.random.PRNGKey(0)), cfg, (6.0, 7.0, 5.0), 3.2,
                      velocity=(1.0, 0.0, -2.0))
    tst = t_sim.seed_sphere(t_sim.new_state(tcfg, "cpu"), tcfg, (6.0, 7.0, 5.0), 3.2,
                            velocity=(1.0, 0.0, -2.0))
    solid = np.random.default_rng(4).uniform(size=cfg.grid_size) < 0.2
    jst = set_solid(set_solid(jst, solid), solid[::-1])
    tst = t_state.set_solid(t_state.set_solid(tst, solid), solid[::-1].copy())
    a = _state_arrays(jst)
    b = convert.state_to_numpy(tst)
    assert a["active"].sum() > 0
    for key in convert.STATE_KEYS:
        np.testing.assert_array_equal(b[key], a[key])


class JaxDraws:
    """The JAX package's random draws of a substep, handed to the port in
    the order the JAX package splits ``state.key``: the sources' candidate
    offsets first, then the correction's jitter seed."""

    def __init__(self, key):
        self.key = key

    def source_jitter(self, s, cfg):
        self.key, sub = jax.random.split(self.key)
        u = jax.random.uniform(sub, (s, sources_mod.MAX_SEED_PER_CELL, 3), jnp.float32,
                               0.0, cfg.cell_size)
        return torch.from_numpy(np.array(u))

    def correction_seed(self):
        self.key, sub = jax.random.split(self.key)
        return int(jitterhash.seed_from_key(sub))


def _with_coincident(state, n_dup=24):
    """Copy the first `n_dup` active particles into free slots: exactly
    coincident pairs, so the correction's jitter (and its seed) matter."""
    pos = np.array(state.position)
    act = np.array(state.active)
    src = np.flatnonzero(act)[:: 97][:n_dup]
    dst = np.flatnonzero(~act)[: src.size]
    pos[dst] = pos[src]
    act[dst] = True
    return state._replace(position=jnp.asarray(pos), active=jnp.asarray(act))


def _assert_substep_parity(cfg, state, j_state, j_diag, t_state, t_diag):
    a, b = _compare(j_state, t_state, pos_atol=1e-4)
    for key in ("velocity", "affine"):
        scale = float(np.max(np.abs(a[key]))) + 1e-12
        np.testing.assert_allclose(b[key], a[key], rtol=0, atol=1e-3 * scale)
    for key in ("particle_count", "overflow_count", "correction_uncorrected"):
        assert int(getattr(t_diag, key)) == int(getattr(j_diag, key)), key
    assert abs(int(t_diag.pressure_iterations) - int(j_diag.pressure_iterations)) <= 1
    for key in ("kinetic_energy", "potential_energy"):
        np.testing.assert_allclose(
            float(getattr(t_diag, key)), float(getattr(j_diag, key)), rtol=1e-4
        )
    assert float(t_diag.pressure_residual) < cfg.solver.tolerance


def test_substep_with_correction_matches_jax():
    """The 12^3 dam-break with position correction on; a small correction
    overflow capacity leaves some particles uncorrected on both sides."""
    cfg, state = _dam_break(12)
    cfg = dataclasses.replace(
        cfg, enable_position_correction=True, max_neighbors_per_cell=6,
        correction_capacity=6, correction_overflow_capacity=4,
    )
    state = _with_coincident(state)
    tcfg, tstate = _port(cfg, state)

    j_state, j_diag = _jax_substep(cfg, 0.05)(state)
    t_state, t_diag = t_sim.substep(tstate, tcfg, 0.05, draws=JaxDraws(state.key))
    _assert_substep_parity(cfg, state, j_state, j_diag, t_state, t_diag)
    assert int(j_diag.overflow_count) > 0 and int(j_diag.correction_uncorrected) > 0


def _obstacle_source_scene():
    """16^3 with a solid block in the falling column's way, a coercing
    source cell row and a non-coercing one, correction and obstacles on."""
    cfg = SimConfig(
        grid_size=(16, 16, 16), cell_size=1.0, gravity=(0.0, -10.0, 0.0),
        particle_capacity=1 << 13, scheme=TransferScheme.APIC,
    )
    state = new_state(cfg, jax.random.PRNGKey(7))
    state = seed_box(state, cfg, (2.5, 6.5, 2.5), (6.0, 6.0, 6.0), velocity=(0.0, -100.0, 0.0))
    solid = np.zeros(cfg.grid_size, bool)
    solid[3:9, 2:4, 3:9] = True
    state = set_solid(state, solid)
    src = sources_mod.make_source_set(
        cells=[[12, 10, z] for z in range(4, 8)] + [[13, 12, 5]],
        velocity=[[-30.0, 0.0, 0.0]] * 4 + [[0.0, 0.0, 0.0]],
        coerce_velocity=[True] * 4 + [False],
        target_density=[2, 2, 2, 2, 1],
    )
    return cfg, state._replace(sources=src)


def _port_sources(src):
    return t_state.SourceSet(*(torch.as_tensor(np.array(a)) for a in src))


def test_substep_with_obstacle_and_source_matches_jax():
    """Two substeps: the JAX package's key chain carries over between them
    as the port's draws do."""
    cfg, state = _obstacle_source_scene()
    tcfg, tstate = _port(cfg, state)
    tstate = tstate._replace(sources=_port_sources(state.sources))

    j_state, draws = state, JaxDraws(state.key)
    t_state = tstate
    for _ in range(2):
        j_state, j_diag = _jax_substep(cfg, 0.02)(j_state)
        t_state, t_diag = t_sim.substep(t_state, tcfg, 0.02, draws=draws)
    _assert_substep_parity(cfg, state, j_state, j_diag, t_state, t_diag)
    assert int(j_diag.particle_count) > int(np.asarray(state.active).sum())


def test_seed_sources_matches_jax():
    """Seeding with JAX's own draw injected: the same candidates are
    accepted into the same free slots."""
    cfg, state = _obstacle_source_scene()
    rng = np.random.default_rng(2)
    occupancy = rng.integers(0, 9, size=cfg.grid_size).astype(np.int32)
    want = sources_mod.seed_sources(state, jnp.asarray(occupancy), cfg)

    tcfg, tstate = _port(cfg, state)
    tstate = tstate._replace(sources=_port_sources(state.sources))
    s = state.sources.cells.shape[0]
    jitter = JaxDraws(state.key).source_jitter(s, cfg)
    got = t_sources.seed_from_jitter(tstate, torch.from_numpy(occupancy), tcfg, jitter)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    np.testing.assert_array_equal(got.position.numpy(), np.asarray(want.position))
    np.testing.assert_array_equal(got.velocity.numpy(), np.asarray(want.velocity))
    assert int(got.active.sum()) > int(tstate.active.sum())
    # seed_sources draws the same offsets from the state's generator
    own = t_sources.source_jitter(t_state.make_generator(0), s, tcfg)
    tstate = tstate._replace(generator=t_state.make_generator(0))
    np.testing.assert_array_equal(
        t_sources.seed_sources(tstate, torch.from_numpy(occupancy), tcfg).position.numpy(),
        t_sources.seed_from_jitter(tstate, torch.from_numpy(occupancy), tcfg, own).position.numpy(),
    )


def test_make_source_set_equals_jax():
    args = dict(cells=[[1, 2, 3], [4, 5, 6]], velocity=(1.0, -2.0, 0.5),
                coerce_velocity=True, target_density=3)
    want = sources_mod.make_source_set(**args)
    got = t_sources.make_source_set(**args, device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_generator_round_trip():
    """A port state's generator survives convert, so a carried-over state
    draws the same numbers as the original."""
    cfg, state = _dam_break(12)
    tcfg, tstate = _port(cfg, state)
    arrays = convert.state_to_numpy(tstate)
    copy = convert.state_from_numpy(arrays, tcfg, "cpu")
    assert t_sim.Draws(tstate.generator).correction_seed() == t_sim.Draws(copy.generator).correction_seed()
