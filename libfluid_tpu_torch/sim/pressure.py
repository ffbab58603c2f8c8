"""Pressure Poisson projection: matrix-free MG-preconditioned CG on the dense
grid (port of ``libfluid_tpu.sim.pressure``, forward only).

- A over fluid cells: diag = #non-solid neighbors (out of bounds counts as
  solid), off-diagonal -1 between fluid neighbors, scaled by
  a_scale = dt / (density * h^2).
- b = -(1/h) * divergence with faces adjacent to solid cells read as 0.
- apply_pressure updates every face adjacent to >= 1 fluid cell: faces
  against solid are set to 0, the others get u -= dt/(rho*h) * (pR - pL)
  with p = 0 in air.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libfluid_tpu_torch import grids
from libfluid_tpu_torch.config import CellType, SimConfig
from libfluid_tpu_torch.sim import multigrid


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
        raise NotImplementedError(
            "the bfloat16 V-cycle ('mg16') is not ported yet (ROADMAP: "
            "FLIP and mg16)"
        )

    def apply_M(r):
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
    return _cg(
        levels, b, a_scale, cfg.solver.tolerance, cfg.solver.max_iterations,
        _precond_tag(cfg), x0=x0,
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
