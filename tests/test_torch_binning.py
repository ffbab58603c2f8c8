"""The port's single-process binning helpers against the JAX package's on the
same numpy-seeded inputs: ``binning.bin_particles``, ``sort_by_cell``,
``gather_neighbors``, ``slots.build`` and ``grids.unflatten_cell_index``,
with inactive particles and a crammed cell (more particles than slots)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu import grids as j_grids
from libfluid_tpu.config import SimConfig
from libfluid_tpu.sim import binning as j_binning
from libfluid_tpu.sim import slots as j_slots
from libfluid_tpu.sim.state import SimState as JState
from libfluid_tpu_torch import convert, grids
from libfluid_tpu_torch.sim import binning, slots

torch.set_num_threads(1)


def _particles(seed=0, n=600):
    """`n` rows on a 6 x 5 x 7 grid of cell 0.5 offset by (-1, 0.5, 0): a
    third inactive, 30 crammed into one cell, some outside the domain."""
    cfg = SimConfig(grid_size=(6, 5, 7), cell_size=0.5, grid_offset=(-1.0, 0.5, 0.0),
                    particle_capacity=n, max_neighbors_per_cell=6)
    rng = np.random.default_rng(seed)
    lo = np.asarray(cfg.domain_min) - 0.2
    hi = np.asarray(cfg.domain_max) + 0.2
    pos = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    pos[:30] = np.asarray([0.3, 1.6, 1.1], np.float32) + rng.uniform(0, 0.4, (30, 3)).astype(np.float32)
    active = rng.uniform(size=n) > 0.33
    active[:30] = True
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    aff = rng.normal(size=(n, 3, 3)).astype(np.float32)
    return cfg, pos, vel, aff, active


def _bins_equal(got, want):
    for name in ("order", "cell_of", "cell_start", "cell_count", "occupancy"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_bin_particles_equals_jax(seed):
    cfg, pos, _, _, act = _particles(seed)
    tcfg = convert.config_from_fields(**vars(cfg))
    want = j_binning.bin_particles(jnp.asarray(pos), jnp.asarray(act), cfg)
    got = binning.bin_particles(torch.from_numpy(pos), torch.from_numpy(act), tcfg)
    _bins_equal(got, want)
    assert int(got.cell_count.max()) > cfg.max_neighbors_per_cell


def test_sort_by_cell_and_build_equal_jax():
    cfg, pos, vel, aff, act = _particles(2)
    tcfg = convert.config_from_fields(**vars(cfg))
    n = pos.shape[0]
    jst = JState(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(aff), jnp.asarray(act),
                 None, None, None, None, None, None)
    jst, jb = j_binning.sort_by_cell(jst, cfg)
    tst = convert.state_from_numpy(
        dict(position=pos, velocity=vel, affine=aff, active=act, **_empty_grid(tcfg)), tcfg, "cpu"
    )
    tst, tb = binning.sort_by_cell(tst, tcfg)
    _bins_equal(tb, jb)
    for name in ("position", "velocity", "affine", "active"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(), np.asarray(getattr(jst, name)), err_msg=name)
    assert tb.order.tolist() == list(range(n))

    for use_affine in (True, False):
        want = j_slots.build(jst.position, jst.velocity, jst.affine if use_affine else None, jb, cfg)
        got = slots.build(tst.position, tst.velocity, tst.affine if use_affine else None, tb, tcfg)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        np.testing.assert_array_equal(got.slot_of.numpy(), np.asarray(want.slot_of))
        np.testing.assert_array_equal(got.overflow.numpy(), np.asarray(want.overflow))
    assert bool(got.overflow.any())


def _empty_grid(cfg):
    nx, ny, nz = cfg.grid_size
    return dict(
        u=np.zeros((nx + 1, ny, nz), np.float32), v=np.zeros((nx, ny + 1, nz), np.float32),
        w=np.zeros((nx, ny, nz + 1), np.float32), cell_type=np.zeros((nx, ny, nz), np.int8),
        solid=np.zeros((nx, ny, nz), bool), pressure=np.zeros((nx, ny, nz), np.float32),
        time=np.zeros((), np.float32),
    )


@pytest.mark.parametrize("max_per_cell", [None, 3])
def test_gather_neighbors_equals_jax(max_per_cell):
    cfg, pos, _, _, act = _particles(3)
    tcfg = convert.config_from_fields(**vars(cfg))
    jb = j_binning.bin_particles(jnp.asarray(pos), jnp.asarray(act), cfg)
    tb = binning.bin_particles(torch.from_numpy(pos), torch.from_numpy(act), tcfg)
    want_ids, want_valid = j_binning.gather_neighbors(jb, jnp.asarray(pos), cfg, max_per_cell)
    got_ids, got_valid = binning.gather_neighbors(tb, torch.from_numpy(pos), tcfg, max_per_cell)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    assert bool(got_valid.any()) and not bool(got_valid.all())


def test_unflatten_cell_index_equals_jax():
    cfg, pos, _, _, _ = _particles(4)
    tcfg = convert.config_from_fields(**vars(cfg))
    raw = np.arange(cfg.num_cells, dtype=np.int32)
    want = j_grids.unflatten_cell_index(jnp.asarray(raw), cfg)
    got = grids.unflatten_cell_index(torch.from_numpy(raw), tcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    idx3 = grids.cell_index_of(torch.from_numpy(pos), tcfg)
    back = grids.unflatten_cell_index(grids.flat_cell_index(idx3, tcfg), tcfg)
    assert torch.equal(back, idx3)
