"""Parity of the options the PyTorch port gained beside its first slices with
the JAX package: the bfloat16 V-cycle ("mg16"), ``build_operator`` /
``apply_A``, ``velocity_at``, the scatter-form ``p2g`` and the FLIP blend
(the FLIP substep itself is a case of ``test_torch_substep.py``).

Tolerances: float32 results as the port's other parity tests take them;
the mg16 solve, whose bfloat16 rounding happens at other places in the two
frameworks (XLA keeps float32 between fused operations), by its CG
iteration count (within 2) and its solution to the solver tolerance."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu import grids
from libfluid_tpu.config import SimConfig, SolverConfig, TransferScheme
from libfluid_tpu.sim import pressure, transfers
from libfluid_tpu_torch import convert
from libfluid_tpu_torch import grids as t_grids
from libfluid_tpu_torch.sim import kernels as t_kernels
from libfluid_tpu_torch.sim import multigrid as t_multigrid
from libfluid_tpu_torch.sim import pressure as t_pressure
from libfluid_tpu_torch.sim import transfers as t_transfers

from test_torch_pressure import SCENES, _scene

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_mg16_solve_matches_jax(name):
    cfg, grid, tcfg, tgrid = _scene(**SCENES[name])
    solver = SolverConfig(preconditioner_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, solver=solver)
    tcfg = dataclasses.replace(tcfg, solver=solver)
    want = pressure.solve(grid, cfg, 0.02)
    t_kernels.reset_launches()
    got = t_pressure.solve(tgrid, tcfg, 0.02)
    assert int(want.iterations) > 0
    assert abs(int(got.iterations) - int(want.iterations)) <= 2
    assert float(got.residual) < cfg.solver.tolerance
    scale = float(np.max(np.abs(np.asarray(want.pressure))))
    np.testing.assert_allclose(got.pressure.numpy(), np.asarray(want.pressure), rtol=0,
                               atol=1e-4 * scale)
    # the float32 solve of the same system takes no more iterations
    f32 = t_pressure.solve(tgrid, dataclasses.replace(tcfg, solver=SolverConfig()), 0.02)
    assert int(f32.iterations) <= int(got.iterations)


def test_mg16_cycle_runs_in_bfloat16():
    """The V-cycle's stencil passes see bfloat16 tensors (kernel C's bf16
    instance on the card) and every mode matches the float32 pass to
    bfloat16's precision."""
    _, _, _, tgrid = _scene(**SCENES["odd"])
    levels = t_multigrid.build_levels(tgrid.cell_type)
    rng = np.random.default_rng(0)
    for lvl in levels:
        l16 = t_multigrid.MGLevel(*[f.to(torch.bfloat16) for f in lvl[:-1]], lvl.scale)
        x = torch.from_numpy(rng.standard_normal(lvl.fluid.shape).astype(np.float32)) * lvl.fluid
        b = torch.from_numpy(rng.standard_normal(lvl.fluid.shape).astype(np.float32)) * lvl.fluid
        for mode in (t_multigrid.MODE_APPLY, t_multigrid.MODE_JACOBI, t_multigrid.MODE_RESIDUAL):
            y16 = t_multigrid.stencil(l16, x.to(torch.bfloat16), b.to(torch.bfloat16), mode, 0.8)
            y32 = t_multigrid.stencil(lvl, x, b, mode, 0.8)
            assert y16.dtype == torch.bfloat16
            scale = float(y32.abs().max()) + 1e-12
            assert float((y16.float() - y32).abs().max()) < 2e-2 * scale


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_operator_and_apply_A_match_jax(name):
    cfg, grid, _, tgrid = _scene(**SCENES[name])
    op = pressure.build_operator(grid.cell_type)
    top = t_pressure.build_operator(tgrid.cell_type)
    for a, b in zip(top, op):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    p = np.random.default_rng(1).standard_normal(cfg.grid_size).astype(np.float32)
    a_scale = 0.02 / (cfg.density * cfg.cell_size**2)
    want = np.asarray(pressure.apply_A(op, jnp.asarray(p), a_scale))
    got = t_pressure.apply_A(top, _t(p), a_scale).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * float(np.abs(want).max()))


def _cloud(scheme, seed):
    """Random particles over a 10x8x9 grid with an offset, a few of them
    outside the face arrays' reach (their samples read zero)."""
    cfg = SimConfig(grid_size=(10, 8, 9), cell_size=0.7, grid_offset=(0.3, -0.4, 0.2),
                    particle_capacity=1 << 10, scheme=scheme)
    rng = np.random.default_rng(seed)
    n = cfg.particle_capacity
    lo, hi = np.array(cfg.domain_min), np.array(cfg.domain_max)
    pos = rng.uniform(lo - 0.5, hi + 0.5, (n, 3)).astype(np.float32)
    vel = rng.standard_normal((n, 3)).astype(np.float32)
    aff = (rng.standard_normal((n, 3, 3)) * 0.2).astype(np.float32)
    active = rng.uniform(size=n) < 0.9
    return cfg, convert.config_from_fields(**vars(cfg)), pos, vel, aff, active


def test_velocity_at_matches_jax():
    cfg, tcfg, pos, *_ = _cloud(TransferScheme.FLIP, 2)
    rng = np.random.default_rng(3)
    nx, ny, nz = cfg.grid_size
    uvw = [rng.standard_normal(s).astype(np.float32)
           for s in ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))]
    grid = grids.zeros(cfg)._replace(u=jnp.asarray(uvw[0]), v=jnp.asarray(uvw[1]),
                                     w=jnp.asarray(uvw[2]))
    want = np.asarray(grids.velocity_at(grid, jnp.asarray(pos), cfg))
    got = t_grids.velocity_at(t_grids.MacGrid(*(_t(a) for a in uvw), None), _t(pos), tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("scheme", [TransferScheme.APIC, TransferScheme.FLIP])
def test_scatter_p2g_and_flip_blend_match_jax(scheme):
    cfg, tcfg, pos, vel, aff, active = _cloud(scheme, 4)
    want = transfers.p2g(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(aff),
                         jnp.asarray(active), cfg)
    got = t_transfers.p2g(_t(pos), _t(vel), _t(aff), _t(active), tcfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-5 * float(np.abs(np.asarray(w)).max()))
    # FLIP blend from the P2G grid (new) and a perturbed copy (old)
    cfg = dataclasses.replace(cfg, blending_factor=0.95)
    tcfg = dataclasses.replace(tcfg, blending_factor=0.95)
    new = grids.zeros(cfg)._replace(u=want[0], v=want[1], w=want[2])
    old = new._replace(u=new.u * 0.5, w=new.w + 1.0)
    j = np.asarray(transfers.g2p_flip(new, old, jnp.asarray(pos), jnp.asarray(vel), cfg))
    tnew = t_grids.MacGrid(*(_t(a) for a in (new.u, new.v, new.w)), None)
    told = t_grids.MacGrid(*(_t(a) for a in (old.u, old.v, old.w)), None)
    t = t_transfers.g2p_flip(tnew, told, _t(pos), _t(vel), tcfg).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)


def test_flip_substep_grad_is_finite():
    """FLIP with mg16 differentiates: the gradient of the end positions with
    respect to the initial velocities flows through P2G, both solves and the
    FLIP blend."""
    from libfluid_tpu_torch import sim

    cfg = SimConfig(grid_size=(8, 8, 8), particle_capacity=1 << 10, gravity=(0.0, -10.0, 0.0),
                    scheme=TransferScheme.FLIP, enable_position_correction=False,
                    has_obstacles=False, solver=SolverConfig(preconditioner_dtype="bfloat16"))
    tcfg = convert.config_from_fields(**vars(cfg))
    state = sim.seed_box(sim.new_state(tcfg, "cpu"), tcfg, (0.5, 0.5, 0.5), (4.0, 4.0, 4.0))
    vel = state.velocity.clone().requires_grad_()
    st = state._replace(velocity=vel)
    t_pressure.ADJOINT_SOLVES.clear()
    for _ in range(2):
        st, _ = sim.substep(st, tcfg, 0.05)
    act = st.active.to(torch.float32)
    loss = torch.sum((torch.sum(st.position, -1) + st.velocity[:, 1]) * act)
    (g,) = torch.autograd.grad(loss, vel)
    g = g[state.active]
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    assert len(t_pressure.ADJOINT_SOLVES) == 2
