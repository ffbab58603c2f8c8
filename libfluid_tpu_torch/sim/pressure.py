"""Pressure Poisson projection: matrix-free MG-preconditioned CG on the dense
grid (port of ``libfluid_tpu.sim.pressure``).

- A over fluid cells: diag = #non-solid neighbors (out of bounds counts as
  solid), off-diagonal -1 between fluid neighbors, scaled by
  a_scale = dt / (density * h^2).
- b = -(1/h) * divergence with faces adjacent to solid cells read as 0.
- apply_pressure updates every face adjacent to >= 1 fluid cell: faces
  against solid are set to 0, the others get u -= dt/(rho*h) * (pR - pL)
  with p = 0 in air.
- The solve is differentiable with respect to b by the implicit function
  theorem (:func:`solve_pressure_system`): A is symmetric, so the adjoint of
  p = A^-1 b is one more solve, b_bar = A^-1 p_bar, started cold. The warm
  start, the operator and a_scale get no gradient.
- "mg16" runs the V-cycle on a bfloat16 copy of the level hierarchy (kernel
  C's bf16 instance, "stencil16"); the outer CG stays in float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libfluid_tpu_torch import grids
from libfluid_tpu_torch.config import CellType, SimConfig
from libfluid_tpu_torch.sim import multigrid


class PoissonOperator(NamedTuple):
    """Masks of the masked 7-point Laplacian."""

    fluid: torch.Tensor  # (nx, ny, nz) 1.0 where fluid
    couple_u: torch.Tensor  # (nx+1, ny, nz) 1.0 where the x-face joins two fluid cells
    couple_v: torch.Tensor  # (nx, ny+1, nz)
    couple_w: torch.Tensor  # (nx, ny, nz+1)
    diag: torch.Tensor  # (nx, ny, nz) #non-solid neighbours, on fluid cells


def build_operator(cell_type: torch.Tensor, dtype=torch.float32) -> PoissonOperator:
    """The operator's masks (port of ``pressure.build_operator``; the same
    masks as the finest multigrid level)."""
    lvl = multigrid.build_levels(cell_type, dtype)[0]
    return PoissonOperator(lvl.fluid, lvl.couple_u, lvl.couple_v, lvl.couple_w, lvl.diag)


def apply_A(op: PoissonOperator, p: torch.Tensor, a_scale) -> torch.Tensor:
    """y = A p on the dense grid, zero outside fluid: kernel C's apply mode
    on CUDA tensors, its plain version on CPU tensors."""
    # a level of scale a_scale; the apply mode reads no inv_diag
    level = multigrid.MGLevel(
        op.fluid, op.diag, op.diag, op.couple_u, op.couple_v, op.couple_w, float(a_scale)
    )
    return multigrid.apply_level(level, p)


def open_face_masks(cell_type: torch.Tensor, dtype=torch.float32):
    """1.0 on faces whose two adjacent cells (out of bounds = solid) are both
    non-solid."""
    sp = grids.pad1(cell_type == CellType.SOLID, True)
    open_u = (~sp[:-1, 1:-1, 1:-1] & ~sp[1:, 1:-1, 1:-1]).to(dtype)
    open_v = (~sp[1:-1, :-1, 1:-1] & ~sp[1:-1, 1:, 1:-1]).to(dtype)
    open_w = (~sp[1:-1, 1:-1, :-1] & ~sp[1:-1, 1:-1, 1:]).to(dtype)
    return open_u, open_v, open_w


def compute_rhs(grid: grids.MacGrid, cfg: SimConfig) -> torch.Tensor:
    """b = -(1/h) div(u_eff), solid-adjacent faces read as 0."""
    open_u, open_v, open_w = open_face_masks(grid.cell_type, cfg.dtype)
    ue = grid.u * open_u
    ve = grid.v * open_v
    we = grid.w * open_w
    div = (
        (ue[1:] - ue[:-1]) + (ve[:, 1:] - ve[:, :-1]) + (we[:, :, 1:] - we[:, :, :-1])
    )
    fluid = (grid.cell_type == CellType.FLUID).to(cfg.dtype)
    return -div / cfg.cell_size * fluid


class PressureResult(NamedTuple):
    pressure: torch.Tensor  # (nx,ny,nz); zero outside fluid
    residual: torch.Tensor  # max |r| at exit
    iterations: torch.Tensor  # int32


def _safe(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x != 0.0, x, torch.ones_like(x))


def _cg(levels, b: torch.Tensor, a_scale, tol, max_iters, precond, x0=None) -> PressureResult:
    """Preconditioned CG with a fixed iteration bound. The early-out on tiny
    ||b||^2 (< 1e-6) skips the loop. The loop reads the residual on the host
    once per iteration to test for exit."""
    lvl0 = levels[0]
    if precond == "mg16":
        # bfloat16 copy of the hierarchy for the preconditioner sweeps; the
        # outer CG iteration stays in b's dtype
        levels16 = tuple(
            multigrid.MGLevel(*[f.to(torch.bfloat16) for f in lev[:-1]], lev.scale)
            for lev in levels
        )

    def apply_M(r):
        if precond == "mg16":
            return multigrid.v_cycle(levels16, r.to(torch.bfloat16)).to(r.dtype) / a_scale
        if precond == "mg":
            return multigrid.v_cycle(levels, r) / a_scale
        return lvl0.inv_diag / a_scale * r

    def apply_A1(p):
        return multigrid.apply_level(lvl0, p) * a_scale

    b2 = torch.sum(b * b)
    nontrivial = bool(b2 >= 1e-6)
    if x0 is None:
        p = torch.zeros_like(b)
        r = b
    else:
        # warm start; when the early-out skips the loop the result is the
        # zero pressure of the cold start, not the stale x0
        p = x0 * lvl0.fluid if nontrivial else torch.zeros_like(b)
        r = b - apply_A1(p)
    z = apply_M(r)
    s = z
    sigma = torch.sum(z * r)
    res = torch.amax(torch.abs(r)) if nontrivial else torch.zeros((), dtype=b.dtype, device=b.device)

    it = 0
    while nontrivial and it < max_iters and bool(res >= tol):
        z = apply_A1(s)
        alpha = sigma / _safe(torch.sum(z * s))
        p = p + alpha * s
        r = r - alpha * z
        res = torch.amax(torch.abs(r))
        z = apply_M(r)
        sigma_new = torch.sum(z * r)
        beta = sigma_new / _safe(sigma)
        s = z + beta * s
        sigma = sigma_new
        it += 1
    return PressureResult(
        pressure=p * lvl0.fluid,
        residual=res,
        iterations=torch.tensor(it, dtype=torch.int32, device=b.device),
    )


# (iterations, residual) of every adjoint solve since the caller last
# cleared the list: what the backward pass did, for the caller to read
ADJOINT_SOLVES = []


class _Solve(torch.autograd.Function):
    """The CG solve, differentiable with respect to b (port of
    ``pressure.solve_pressure_system``'s ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, b, x0, levels, a_scale, tol, max_iters, precond):
        res = _cg(levels, b, a_scale, tol, max_iters, precond, x0=x0)
        ctx.args = (levels, a_scale, tol, max_iters, precond)
        ctx.mark_non_differentiable(res.residual, res.iterations)
        return res.pressure, res.residual, res.iterations

    @staticmethod
    def backward(ctx, g, _g_residual, _g_iterations):
        levels, a_scale, tol, max_iters, precond = ctx.args
        adj = _cg(levels, g * levels[0].fluid, a_scale, tol, max_iters, precond)
        ADJOINT_SOLVES.append((int(adj.iterations), float(adj.residual)))
        return adj.pressure, None, None, None, None, None, None


def solve_pressure_system(levels, b: torch.Tensor, a_scale, x0, tol, max_iters, precond) -> PressureResult:
    """p = A^-1 b (restricted to fluid cells), differentiable with respect to
    b: the backward is one cold-start solve b_bar = A^-1 (p_bar * fluid) with
    the same levels, preconditioner and tolerance (kernel C on CUDA). The
    warm start `x0`, the levels and a_scale get no gradient."""
    return PressureResult(*_Solve.apply(b, x0, levels, a_scale, tol, max_iters, precond))


def _precond_tag(cfg: SimConfig) -> str:
    """"mg"/"jacobi", "mg16" for the bfloat16 cycle."""
    p = cfg.solver.preconditioner
    if p == "mg" and cfg.solver.preconditioner_dtype == "bfloat16":
        return "mg16"
    return p


def solve(grid: grids.MacGrid, cfg: SimConfig, dt, x0=None) -> PressureResult:
    """Assemble and solve the pressure system for the current grid state."""
    levels = multigrid.build_levels(grid.cell_type, cfg.dtype)
    a_scale = dt / (cfg.density * cfg.cell_size * cfg.cell_size)
    b = compute_rhs(grid, cfg)
    if x0 is None:
        x0 = torch.zeros_like(b)
    return solve_pressure_system(
        levels, b, a_scale, x0, cfg.solver.tolerance, cfg.solver.max_iterations,
        _precond_tag(cfg),
    )


def apply_pressure(grid: grids.MacGrid, pressure: torch.Tensor, cfg: SimConfig, dt) -> grids.MacGrid:
    """Subtract the pressure gradient from the faces next to fluid; faces of
    fluid cells against solid are pinned to 0."""
    coeff = dt / (cfg.density * cfg.cell_size)
    fluid_b = grid.cell_type == CellType.FLUID
    fp = grids.pad1(fluid_b, False)
    pp = grids.pad1(pressure * fluid_b.to(pressure.dtype), 0.0)
    open_u, open_v, open_w = open_face_masks(grid.cell_type, cfg.dtype)

    def update(face_vel, axis, open_m):
        lo = [slice(1, -1)] * 3
        hi = [slice(1, -1)] * 3
        lo[axis] = slice(None, -1)
        hi[axis] = slice(1, None)
        p_l, p_r = pp[tuple(lo)], pp[tuple(hi)]
        touched = fp[tuple(lo)] | fp[tuple(hi)]
        updated = face_vel - coeff * (p_r - p_l)
        new_vel = torch.where(open_m > 0, updated, torch.zeros_like(updated))
        return torch.where(touched, new_vel, face_vel)

    return grid._replace(
        u=update(grid.u, 0, open_u), v=update(grid.v, 1, open_v), w=update(grid.w, 2, open_w)
    )
