"""Parity of the PyTorch port's fused sort + slot-grid build with the JAX
package: pure data movement, so every output must be EQUAL, overflow
included (K is small enough that cells overflow)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu.config import SimConfig, TransferScheme
from libfluid_tpu.sim import slots, slotsort
from libfluid_tpu.sim.state import new_state
from libfluid_tpu_torch import convert
from libfluid_tpu_torch.sim import slots as t_slots
from libfluid_tpu_torch.sim import slotsort as t_slotsort

torch.set_num_threads(1)


def _states(grid, k, scheme, seed=0):
    """The same random particle set (half of it clustered, 70% active) as a
    JAX state and as a port state."""
    cfg = SimConfig(
        grid_size=grid, particle_capacity=4096, max_neighbors_per_cell=k,
        scheme=scheme, has_obstacles=False,
    )
    rng = np.random.default_rng(seed)
    n = cfg.particle_capacity
    lo = np.asarray(cfg.domain_min) + 0.05
    hi = np.asarray(cfg.domain_max) - 0.05
    pos = rng.uniform(lo, hi, size=(n, 3))
    centers = rng.uniform(lo, hi, size=(8, 3))
    m = n // 2
    pos[:m] = centers[rng.integers(0, 8, m)] + rng.normal(0, 0.3, (m, 3))
    pos = np.clip(pos, lo, hi).astype(np.float32)
    vel = rng.standard_normal((n, 3)).astype(np.float32)
    aff = rng.standard_normal((n, 3, 3)).astype(np.float32)
    active = rng.uniform(size=n) < 0.7
    jst = new_state(cfg, jax.random.PRNGKey(seed))._replace(
        position=jnp.asarray(pos), velocity=jnp.asarray(vel),
        affine=jnp.asarray(aff), active=jnp.asarray(active),
    )
    s = jax.tree_util.tree_map(np.asarray, jst)
    tcfg = convert.config_from_fields(**vars(cfg))
    tst = convert.state_from_numpy(
        dict(position=pos, velocity=vel, affine=aff, active=active, u=s.grid.u,
             v=s.grid.v, w=s.grid.w, cell_type=s.grid.cell_type, solid=s.solid,
             pressure=s.pressure, time=s.time),
        tcfg, "cpu",
    )
    return cfg, jst, tcfg, tst


def _eq(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.dtype == torch.from_numpy(np.zeros(0, want.dtype)).dtype
    np.testing.assert_array_equal(got.numpy(), want)


CASES = [
    ((12, 10, 8), 4, TransferScheme.APIC),
    ((16, 16, 16), 3, TransferScheme.APIC),
    ((12, 10, 8), 4, TransferScheme.PIC),
]


@pytest.mark.parametrize("grid,k,scheme", CASES)
def test_sort_rank_major_equals_jax(grid, k, scheme):
    cfg, jst, tcfg, tst = _states(grid, k, scheme)
    want = slotsort.sort_rank_major(jst, cfg, pad_cols=0)
    got = t_slotsort.sort_rank_major(tst, tcfg)
    assert int(want.n_overflow) > 0  # the regime under test
    for name in ("key_sorted", "counts", "ins", "n_kept", "n_overflow", "payT"):
        _eq(getattr(got, name), getattr(want, name))
    for name in ("position", "velocity", "affine", "active"):
        _eq(getattr(got.state, name), getattr(want.state, name))


@pytest.mark.parametrize("grid,k,scheme", CASES)
def test_sort_and_build_equals_jax(grid, k, scheme):
    cfg, jst, tcfg, tst = _states(grid, k, scheme, seed=1)
    want = slotsort.sort_and_build(jst, cfg)
    got = t_slotsort.sort_and_build(tst, tcfg)
    _eq(got.slot_grid.data, want.slot_grid.data)
    _eq(got.slot_grid.slot_of, want.slot_grid.slot_of)
    _eq(got.slot_grid.overflow, want.slot_grid.overflow)
    for name in ("cell_of", "cell_start", "cell_count", "occupancy"):
        _eq(getattr(got.bins, name), getattr(want.bins, name))
    _eq(got.n_kept, want.n_kept)
    _eq(got.n_overflow, want.n_overflow)
    for name in ("position", "velocity", "affine", "active"):
        _eq(getattr(got.state, name), getattr(want.state, name))


def test_expand_range_equals_jax():
    """A sub-range of cells: JAX's expand (its gather oracle on the CPU)
    against the port's expand kernel wrapper on CPU tensors."""
    cfg, jst, tcfg, tst = _states((12, 10, 8), 4, TransferScheme.APIC, seed=2)
    c0, num_c = 120, 480
    rs = slotsort.sort_rank_major(jst, cfg, pad_cols=num_c + 2 * slotsort.PAD)
    want = slotsort.expand_range(rs, cfg, jnp.int32(c0), num_c, num_c)
    got = t_slotsort.expand_range(t_slotsort.sort_rank_major(tst, tcfg), tcfg, c0, num_c)
    _eq(got, want)


def test_slot_helpers_equal_jax():
    """gather_per_particle (with and without leading payload dims) and the
    zero-padded neighbour view `shifted`."""
    cfg, jst, tcfg, tst = _states((12, 10, 8), 4, TransferScheme.APIC, seed=3)
    want = slotsort.sort_and_build(jst, cfg).slot_grid
    got = t_slotsort.sort_and_build(tst, tcfg).slot_grid
    _eq(t_slots.gather_per_particle(got.position, got), slots.gather_per_particle(want.position, want))
    _eq(t_slots.gather_per_particle(got.mask, got), slots.gather_per_particle(want.mask, want))
    for off in [(1, 0, -1), (-1, -1, 1), (0, 1, 0)]:
        _eq(t_slots.shifted(got.velocity, off, tcfg), slots.shifted(want.velocity, off, cfg))
