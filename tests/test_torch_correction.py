"""Parity of the PyTorch port's position correction with the JAX package:
the jitter hash bit for bit, the resident springs (kernel E's plain
version), the overflow pass and ``correct_positions``.

Tolerances: the springs as in the JAX package's own kernel-vs-oracle test
(``tests/test_tpu_kernels.py``: max error / (100 max|pos|) < 2e-6, since
``pos * wsum - wnbr`` cancels); positions atol 1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu.config import SimConfig, TransferScheme
from libfluid_tpu.sim import binning as binning_mod
from libfluid_tpu.sim import correction, jitterhash
from libfluid_tpu.sim import slots as slots_mod
from libfluid_tpu.sim.state import new_state
from libfluid_tpu_torch import convert
from libfluid_tpu_torch.sim import correction as t_correction
from libfluid_tpu_torch.sim import jitterhash as t_jitterhash
from libfluid_tpu_torch.sim import kernels as t_kernels
from libfluid_tpu_torch.sim import slots as t_slots

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_jitter_bits_equal_jax():
    """Random int32 inputs (negative intermediates and wraparound included)
    and the extreme values."""
    rng = np.random.default_rng(0)
    cols = [rng.integers(-(2**31), 2**31, size=4096, dtype=np.int64).astype(np.int32)
            for _ in range(6)]
    edge = np.array([0, 1, -1, 2**31 - 1, -(2**31), 65535, -65536], np.int32)
    cols = [np.concatenate([c, np.roll(edge, i)]) for i, c in enumerate(cols)]
    want = np.asarray(jitterhash.jitter_bits(*(jnp.asarray(c) for c in cols)))
    got = t_jitterhash.jitter_bits(*(_t(c) for c in cols)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        t_jitterhash.jitter_value(*(_t(c) for c in cols)).numpy(),
        np.asarray(jitterhash.jitter_value(*(jnp.asarray(c) for c in cols))),
    )


@pytest.mark.parametrize("origin", [(0, 0, 0), (5, -3, 1000)])
def test_jitter_field_equal_jax(origin):
    want = np.asarray(jitterhash.jitter_field(987654321, 7, (6, 5, 4), origin, jnp.float32))
    got = t_jitterhash.jitter_field(987654321, 7, (6, 5, 4), origin, torch.float32, "cpu").numpy()
    np.testing.assert_array_equal(got, want)


def _slot_fixture(kc=6, shape=(10, 9, 8), h=1.0, seed=11):
    """Prefix-dense resident slots with random counts, in-cell positions,
    and exactly coincident pairs inside cells and across neighbour cells."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = shape
    counts = rng.integers(0, kc + 1, size=shape)
    mask = (np.arange(kc)[:, None, None, None] < counts[None]).astype(np.float32)
    cell = np.stack(np.meshgrid(*(np.arange(n) for n in shape), indexing="ij"))  # (3, nx, ny, nz)
    pos = (cell[:, None] + rng.uniform(0.05, 0.95, (3, kc) + shape)) * h
    full = np.argwhere(counts >= 2)
    for x, y, z in full[:: 3]:
        pos[:, 1, x, y, z] = pos[:, 0, x, y, z]  # same cell
    # a particle on the face between two cells, mirrored into the neighbour
    for x, y, z in full[1:: 5]:
        if x + 1 < nx and counts[x + 1, y, z] >= 1:
            pos[:, 0, x, y, z] = ((x + 1) * h, pos[1, 0, x, y, z], pos[2, 0, x, y, z])
            pos[:, 0, x + 1, y, z] = pos[:, 0, x, y, z]
    pos = (pos * mask[None]).astype(np.float32)
    return pos, mask


@pytest.mark.parametrize("kc,h", [(6, 1.0), (12, 0.8)])
def test_springs_match_jax(kc, h):
    cfg = SimConfig(grid_size=(10, 9, 8), cell_size=h, particle_capacity=64)
    tcfg = convert.config_from_fields(**vars(cfg))
    pos, mask = _slot_fixture(kc, h=h)
    re2 = h * h / 2.0
    want = np.asarray(correction._springs_jnp(jnp.asarray(pos), jnp.asarray(mask), re2,
                                              jnp.int32(12345), cfg))
    t_kernels.reset_launches()
    got = t_correction._springs(_t(pos), _t(mask), 12345, (0, 0, 0), re2, tcfg).numpy()
    assert t_kernels.LAUNCHES["correction"] == 0  # CPU tensors take the plain version
    err = np.max(np.abs(got - want)) / (100.0 * np.max(np.abs(pos)))
    assert err < 2e-6, err
    # the fixture's coincident pairs are live: the jitter moves those slots
    no_jitter = np.asarray(correction._springs_jnp(jnp.asarray(pos), jnp.asarray(mask), re2,
                                                   jnp.int32(54321), cfg))
    assert np.max(np.abs(no_jitter - want)) > 1e-3


def test_springs_at_forty_slots_match_jax():
    """40 slots a cell, more than one word of kernel E's occupancy mask, on
    a small grid: the plain version against the JAX oracle."""
    cfg = SimConfig(grid_size=(4, 3, 5), cell_size=1.0, particle_capacity=64)
    tcfg = convert.config_from_fields(**vars(cfg))
    pos, mask = _slot_fixture(40, h=1.0, shape=cfg.grid_size)
    want = np.asarray(correction._springs_jnp(jnp.asarray(pos), jnp.asarray(mask), 0.5,
                                              jnp.int32(12345), cfg))
    got = t_correction._springs(_t(pos), _t(mask), 12345, (0, 0, 0), 0.5, tcfg).numpy()
    err = np.max(np.abs(got - want)) / (100.0 * np.max(np.abs(pos)))
    assert err < 2e-6, err
    assert float(mask[32:].sum()) > 0  # the second word holds slots


def test_springs_across_tile_edges_match_jax():
    """Particles only in cells 3, 4 and 7, 8 along each axis, the rest of the
    grid empty: the clusters straddle the edges of the CUDA kernel's 4x4x8
    cell tiles, so a slot's pairs lie in the neighbouring tile's cells, which
    a tile has to see as its halo; the empty region gives 0."""
    kc, h, shape = 6, 1.0, (12, 12, 16)
    cfg = SimConfig(grid_size=shape, cell_size=h, particle_capacity=64)
    tcfg = convert.config_from_fields(**vars(cfg))
    pos, mask = _slot_fixture(kc, shape=shape, h=h, seed=13)
    on = [np.isin(np.arange(n), (3, 4, 7, 8)) for n in shape]
    keep = on[0][:, None, None] & on[1][None, :, None] & on[2][None, None, :]
    mask = mask * keep[None]
    mask[0, 3:5, 3:5, 7:9] = 1.0  # both sides of every edge are occupied
    pos = (pos + (pos == 0) * (np.stack(np.meshgrid(
        *(np.arange(n) for n in shape), indexing="ij"))[:, None] + 0.5) * h).astype(np.float32)
    # two pairs a fifth of a cell apart, across x = 4 and across z = 8
    pairs = (((3, 3, 7), (3.9, 3.5, 7.5), (4, 3, 7), (4.1, 3.5, 7.5)),
             ((4, 4, 7), (4.5, 4.5, 7.9), (4, 4, 8), (4.5, 4.5, 8.1)))
    for near, at_near, far, at_far in pairs:
        pos[(slice(None), 0, *near)] = at_near
        pos[(slice(None), 0, *far)] = at_far
    pos = pos * mask[None]
    re2 = h * h / 2.0
    want = np.asarray(correction._springs_jnp(jnp.asarray(pos), jnp.asarray(mask), re2,
                                              jnp.int32(777), cfg))
    got = t_correction._springs(_t(pos), _t(mask), 777, (0, 0, 0), re2, tcfg).numpy()
    err = np.max(np.abs(got - want)) / (100.0 * np.max(np.abs(pos)))
    assert err < 2e-6, err
    assert not got[:, :, ~keep].any()
    # a slot of cell 3 feels cell 4 (across x = 4) and one of cell 7 feels
    # cell 8 along z (across z = 8): emptying the far cell changes its spring
    for near, _, far, _ in pairs:
        alone = mask.copy()
        alone[(slice(None), *far)] = 0.0
        lone = t_correction._springs(_t(pos * alone[None]), _t(alone), 777, (0, 0, 0), re2,
                                     tcfg).numpy()
        assert np.abs(lone[(slice(None), 0, *near)] - got[(slice(None), 0, *near)]).max() > 1e-4


def _crowded_state(n_extra):
    """tests/test_correction.py's fixture: one cell holds
    correction_capacity + n_extra particles (a coincident pair among them)."""
    cfg = SimConfig(
        grid_size=(8, 8, 8), particle_capacity=64, scheme=TransferScheme.APIC,
        max_neighbors_per_cell=16, correction_capacity=8, has_obstacles=False,
    )
    state = new_state(cfg, jax.random.PRNGKey(0))
    m = cfg.correction_capacity + n_extra
    rng = np.random.default_rng(3)
    position = np.zeros((64, 3), np.float32)
    position[:m] = 4.0 + rng.uniform(0.05, 0.95, size=(m, 3))
    position[1] = position[0]
    position[m] = (3.9, 4.5, 4.5)  # one more in the neighbour cell
    active = np.zeros((64,), bool)
    active[: m + 1] = True
    state = state._replace(position=jnp.asarray(position), active=jnp.asarray(active))
    state, bins = binning_mod.sort_by_cell(state, cfg)
    slot_grid = slots_mod.build(state.position, state.velocity, state.affine, bins, cfg)
    tslots = t_slots.SlotGrid(*(_t(a) for a in slot_grid))
    return cfg, convert.config_from_fields(**vars(cfg)), state, slot_grid, tslots


@pytest.mark.parametrize("n_extra", [3, 6])
def test_overflow_springs_match_jax(n_extra):
    cfg, tcfg, state, slot_grid, tslots = _crowded_state(n_extra)
    kc = cfg.correction_capacity
    re2 = cfg.cell_size**2 / 2.0
    truncated = state.active & (slot_grid.slot_of >= kc * cfg.num_cells)
    args = (slot_grid.position[:, :kc], slot_grid.mask[:kc], re2)
    for cap, start in ((16, None), (4, None), (16, 2 * kc)):
        widx, wspr = correction.overflow_springs(state.position, truncated, *args, cfg, cap,
                                                 trunc_start=start)
        gidx, gspr = t_correction.overflow_springs(
            _t(state.position), _t(truncated), tslots.position[:, :kc], tslots.mask[:kc],
            re2, tcfg, cap, trunc_start=None if start is None else torch.tensor(start),
        )
        np.testing.assert_array_equal(gidx.numpy(), np.asarray(widx))
        np.testing.assert_allclose(gspr.numpy(), np.asarray(wspr), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_extra,cap", [(3, 4096), (6, 4)])
def test_correct_positions_match_jax(n_extra, cap):
    cfg, tcfg, state, slot_grid, tslots = _crowded_state(n_extra)
    cfg = dataclasses.replace(cfg, correction_overflow_capacity=cap)
    tcfg = convert.config_from_fields(**vars(cfg))
    key = jax.random.PRNGKey(1)
    want = np.asarray(correction.correct_positions(
        state.position, state.active, slot_grid, cfg, 1.0 / 60.0, key))
    got = t_correction.correct_positions(
        _t(state.position), _t(state.active), tslots, tcfg, 1.0 / 60.0,
        int(jitterhash.seed_from_key(key)),
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got - np.asarray(state.position)).sum() > 0
