"""Parity of the PyTorch port's substep and CFL step with the JAX package, on
the small dam-break scenes of ``test_sim_e2e.py`` with position correction
off. Both packages start from the same seeded state (carried over with
``libfluid_tpu_torch.convert``); the port runs its plain PyTorch versions of
the kernels here (CPU tensors)."""

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
    [(12, TransferScheme.APIC), (16, TransferScheme.APIC), (12, TransferScheme.PIC)],
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
    # a state with sources is refused by the substep, not skipped
    with pytest.raises(NotImplementedError):
        t_sim.substep(tstate._replace(sources=tsrc), tcfg, 0.05)


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
