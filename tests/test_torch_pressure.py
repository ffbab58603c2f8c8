"""Parity of the PyTorch port's pressure projection with the JAX package:
the multigrid hierarchy and kernel C's plain version (apply / damped Jacobi /
residual), the trilinear transfers and V-cycle, the MG-preconditioned CG,
compute_rhs, apply_pressure and velocity extrapolation. Scenes are those of
test_pressure.py and test_multigrid.py, plus an odd-sized one that takes the
SOLID-padding / zero-padding / crop paths of the transfers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu import grids
from libfluid_tpu.config import CellType, SimConfig
from libfluid_tpu.sim import extrapolation, multigrid, pressure
from libfluid_tpu_torch import convert
from libfluid_tpu_torch import grids as t_grids
from libfluid_tpu_torch.sim import extrapolation as t_extrapolation
from libfluid_tpu_torch.sim import multigrid as t_multigrid
from libfluid_tpu_torch.sim import pressure as t_pressure

torch.set_num_threads(1)


def _scene(shape, cell_size, seed, pool_frac, pillar):
    """Solid floor, random fluid in the lower half, air above (and a solid
    pillar where asked): the fixtures of test_pressure.py / test_multigrid.py
    generalized to non-cubic grids."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = shape
    cfg = SimConfig(grid_size=shape, cell_size=cell_size, particle_capacity=8)
    ct = np.full(shape, CellType.AIR, np.int8)
    ct[:, 0, :] = CellType.SOLID
    if pillar:
        ct[nx // 3: nx // 3 + 2, :, nz // 3: nz // 3 + 2] = CellType.SOLID
    else:
        ct[nx // 2, ny // 2, nz // 2] = CellType.SOLID
    fluid = rng.uniform(size=shape) < pool_frac
    fluid[:, ny // 2:, :] = False
    ct[fluid & (ct == CellType.AIR)] = CellType.FLUID
    u = rng.normal(size=(nx + 1, ny, nz)).astype(np.float32)
    v = rng.normal(size=(nx, ny + 1, nz)).astype(np.float32)
    w = rng.normal(size=(nx, ny, nz + 1)).astype(np.float32)
    grid = grids.zeros(cfg)._replace(
        u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w), cell_type=jnp.asarray(ct)
    )
    tcfg = convert.config_from_fields(**vars(cfg))
    tgrid = t_grids.MacGrid(
        u=torch.from_numpy(u), v=torch.from_numpy(v), w=torch.from_numpy(w),
        cell_type=torch.from_numpy(ct),
    )
    return cfg, grid, tcfg, tgrid


SCENES = {
    "pressure8": dict(shape=(8, 8, 8), cell_size=0.5, seed=0, pool_frac=0.5, pillar=False),
    "multigrid16": dict(shape=(16, 16, 16), cell_size=1.0, seed=0, pool_frac=0.6, pillar=True),
    "odd": dict(shape=(19, 13, 11), cell_size=0.8, seed=4, pool_frac=0.7, pillar=True),
}


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("name", ["multigrid16", "odd"])
def test_levels_and_stencil_match_jax(name):
    cfg, grid, tcfg, tgrid = _scene(**SCENES[name])
    levels = multigrid.build_levels(grid.cell_type)
    tlevels = t_multigrid.build_levels(tgrid.cell_type)
    assert len(tlevels) == len(levels) > 1
    rng = np.random.default_rng(1)
    for lvl, tlvl in zip(levels, tlevels):
        assert tlvl.scale == lvl.scale
        for field in ("fluid", "diag", "inv_diag", "couple_u", "couple_v", "couple_w"):
            np.testing.assert_array_equal(getattr(tlvl, field).numpy(), _np(getattr(lvl, field)))
        shape = lvl.fluid.shape
        x = rng.normal(size=shape).astype(np.float32)
        b = (rng.normal(size=shape) * _np(lvl.fluid)).astype(np.float32)
        tx, tb = torch.from_numpy(x), torch.from_numpy(b)
        pairs = [
            (t_multigrid.apply_level(tlvl, tx), multigrid.apply_level(lvl, jnp.asarray(x))),
            (t_multigrid.residual(tlvl, tx, tb), multigrid.residual(lvl, jnp.asarray(x), jnp.asarray(b))),
            (t_multigrid._smooth(tlvl, tx, tb, 2), multigrid._smooth(lvl, jnp.asarray(x), jnp.asarray(b), 2)),
        ]
        for got, want in pairs:
            np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("name", ["multigrid16", "odd"])
def test_transfers_and_vcycle_match_jax(name):
    cfg, grid, tcfg, tgrid = _scene(**SCENES[name])
    levels = multigrid.build_levels(grid.cell_type)
    tlevels = t_multigrid.build_levels(tgrid.cell_type)
    rng = np.random.default_rng(2)
    fine = levels[0].fluid.shape
    r = (rng.normal(size=fine) * _np(levels[0].fluid)).astype(np.float32)
    rc = multigrid._restrict(levels[1], jnp.asarray(r))
    np.testing.assert_allclose(
        t_multigrid._restrict(tlevels[1], torch.from_numpy(r)).numpy(), _np(rc), rtol=1e-6, atol=1e-6
    )
    e = rng.normal(size=rc.shape).astype(np.float32)
    np.testing.assert_allclose(
        t_multigrid._prolong(torch.from_numpy(e), fine).numpy(),
        _np(multigrid._prolong(jnp.asarray(e), fine)), rtol=1e-6, atol=1e-6,
    )
    want = _np(multigrid.v_cycle(levels, jnp.asarray(r)))
    got = t_multigrid.v_cycle(tlevels, torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.max(np.abs(r))))


@pytest.mark.parametrize("name,warm", [("pressure8", False), ("multigrid16", False), ("odd", True)])
def test_solve_matches_jax(name, warm):
    cfg, grid, tcfg, tgrid = _scene(**SCENES[name])
    dt = 0.01
    x0 = None
    tx0 = None
    if warm:
        x0 = np.random.default_rng(3).normal(size=cfg.grid_size).astype(np.float32)
        tx0 = torch.from_numpy(x0)
        x0 = jnp.asarray(x0)
    want = pressure.solve(grid, cfg, dt, x0=x0)
    got = t_pressure.solve(tgrid, tcfg, dt, x0=tx0)
    assert int(want.iterations) > 0
    assert abs(int(got.iterations) - int(want.iterations)) <= 1
    p = _np(want.pressure)
    assert np.max(np.abs(got.pressure.numpy() - p)) <= 1e-4 * np.max(np.abs(p))
    assert float(got.residual) < cfg.solver.tolerance


def test_solve_trivial_rhs_early_out():
    cfg, grid, tcfg, tgrid = _scene(**SCENES["pressure8"])
    zero = tgrid._replace(
        u=torch.zeros_like(tgrid.u), v=torch.zeros_like(tgrid.v), w=torch.zeros_like(tgrid.w)
    )
    got = t_pressure.solve(zero, tcfg, 0.01, x0=torch.ones(cfg.grid_size))
    assert int(got.iterations) == 0
    assert float(torch.max(torch.abs(got.pressure))) == 0.0


@pytest.mark.parametrize("name", ["pressure8", "odd"])
def test_rhs_apply_pressure_extrapolate_match_jax(name):
    cfg, grid, tcfg, tgrid = _scene(**SCENES[name])
    dt = 0.02
    np.testing.assert_allclose(
        t_pressure.compute_rhs(tgrid, tcfg).numpy(), _np(pressure.compute_rhs(grid, cfg)), atol=1e-6
    )
    np.testing.assert_allclose(
        t_grids.divergence(tgrid, tcfg).numpy(), _np(grids.divergence(grid, cfg)), atol=1e-6
    )
    p = np.random.default_rng(6).normal(size=cfg.grid_size).astype(np.float32)
    want = pressure.apply_pressure(grid, jnp.asarray(p), cfg, dt)
    got = t_pressure.apply_pressure(tgrid, torch.from_numpy(p), tcfg, dt)
    for axis in ("u", "v", "w"):
        np.testing.assert_allclose(getattr(got, axis).numpy(), _np(getattr(want, axis)), atol=1e-6)
    want = extrapolation.extrapolate(want, cfg)
    got = t_extrapolation.extrapolate(got, tcfg)
    for axis in ("u", "v", "w"):
        np.testing.assert_allclose(getattr(got, axis).numpy(), _np(getattr(want, axis)), atol=1e-6)
