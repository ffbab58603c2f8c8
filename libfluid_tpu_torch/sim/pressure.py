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
- "mg16" runs the V-cycle on a bfloat16 copy of the level hierarchy (the
  fused cycle's bfloat16 instance, "mg16_*"); the outer CG stays in float32.
- A CG iteration is M^-1 r and two steps, :func:`cg_direction` and
  :func:`cg_update` (kernels "cg_direction" and "cg_update" on the card),
  with CG's scalars and its exit test on the device; the host reads the
  exit flag ``_EXIT_LAG`` iterations behind the queue (:func:`_cg`), where
  JAX runs the loop as one ``lax.while_loop``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libfluid_tpu_torch import grids, profiling
from libfluid_tpu_torch.config import CellType, SimConfig
from libfluid_tpu_torch.sim import kernels, multigrid


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


# The host tests for the solve's exit on a copy of the device's flag taken
# this many iterations behind the last one it enqueued: the card runs the
# iterations in between while the host enqueues the next.
_EXIT_LAG = 2
# floats of the CG kernels' block partials (2 x csrc/cg.cu's kMaxBlocks)
_CG_PARTIALS = 4096

# A CG iteration after M^-1 r = w (the V-cycle or Jacobi), on the solve's
# vectors p, r, s, q (updated in place) and its device scalars sc = [sigma,
# alpha, res, a_scale, m_scale] (b's dtype; z = w / m_scale) and st =
# [iterations, done] (int32). a_scale stays a device value: the time step it
# comes from is one. Each step returns without writing where st's done is
# set; the plain versions test it on the host, the kernels on the device.


def _cg_direction_torch(w, r, s, q, lvl0, first: bool, sc, st) -> None:
    """Plain version of :func:`cg_direction`: the unfused expressions of
    the loop it replaces, in their order."""
    if st[1]:
        return
    z = w / sc[4]
    sigma_new = torch.sum(z * r)
    if first:
        s.copy_(z)
    else:
        beta = sigma_new / _safe(sc[0])
        s.copy_(z + beta * s)
    q.copy_(multigrid.apply_level(lvl0, s) * sc[3])
    sc[1] = sigma_new / _safe(torch.sum(q * s))
    sc[0] = sigma_new


def _cg_update_torch(p, r, s, q, sc, st, tol, max_iters) -> None:
    """Plain version of :func:`cg_update`."""
    if st[1]:
        return
    alpha = sc[1]
    p.add_(alpha * s)
    r.sub_(alpha * q)
    res = torch.amax(torch.abs(r))
    sc[2] = res
    st[0] += 1
    st[1] = ~(res >= tol) | (st[0] >= max_iters)


def _check_cg(r, s, q, sc, st, part, *grid) -> None:
    """Raise unless the CG kernels take these tensors."""
    for name, t in (("r", r), ("s", s), ("q", q), *grid):
        kernels.check(t, torch.float32, r.shape, name)
    kernels.check(sc, torch.float32, (5,), "sc")
    kernels.check(st, torch.int32, (2,), "st")
    kernels.check(part, torch.float32, (_CG_PARTIALS,), "part")


def cg_direction(w, r, s, q, lvl0, first: bool, sc, st, part) -> None:
    """The first half of a CG iteration: z = w / m_scale, sigma' = z . r,
    beta = sigma' / safe(sigma) (0 on the `first` iteration), s = z + beta
    s, q = a_scale A_1 s (the finest level's operator), alpha = sigma' /
    safe(q . s), sigma = sigma'. CUDA: "cg_direction" (``csrc/cg.cu``),
    float32, `part` its scratch; CPU: :func:`_cg_direction_torch`."""
    if not kernels.use_kernel(w, r, s, q, sc, st, lvl0.fluid):
        return _cg_direction_torch(w, r, s, q, lvl0, first, sc, st)
    _check_cg(r, s, q, sc, st, part, ("w", w), ("diag", lvl0.diag), ("fluid", lvl0.fluid))
    nx, ny, nz = r.shape
    kernels.check(lvl0.couple_u, torch.float32, (nx + 1, ny, nz), "couple_u")
    kernels.check(lvl0.couple_v, torch.float32, (nx, ny + 1, nz), "couple_v")
    kernels.check(lvl0.couple_w, torch.float32, (nx, ny, nz + 1), "couple_w")
    kernels.launch(
        "cg_direction", "lf_cg_direction", w, r, s, q, lvl0.diag, lvl0.fluid, lvl0.couple_u,
        lvl0.couple_v, lvl0.couple_w, float(lvl0.scale), int(first), sc, st, part, nx, ny, nz,
    )


def cg_update(p, r, s, q, sc, st, tol, max_iters, part) -> None:
    """The second half: p += alpha s, r -= alpha q, res = max |r|,
    iterations += 1, done = !(res >= tol) or iterations >= max_iters.
    CUDA: "cg_update" (``csrc/cg.cu``), float32; CPU:
    :func:`_cg_update_torch`."""
    if not kernels.use_kernel(p, r, s, q, sc, st):
        return _cg_update_torch(p, r, s, q, sc, st, tol, max_iters)
    _check_cg(r, s, q, sc, st, part, ("p", p))
    kernels.launch("cg_update", "lf_cg_update", p, r, s, q, sc, st, part, r.numel(), float(tol),
                   int(max_iters))


class _ExitFlags:
    """Copies of the device's st = [iterations, done], one taken after each
    iteration the host enqueues (and one before the first), read `lag`
    copies behind the newest. On the card a copy goes to pinned host memory
    without blocking and an event follows it; the host waits on that event
    (read site ``cg.loop``). On the CPU a copy is ready at once."""

    def __init__(self, st: torch.Tensor, lag: int):
        self.st, self.lag = st, lag
        self.cuda = st.device.type == "cuda"
        self.host = torch.empty((lag + 1, 2), dtype=torch.int32, pin_memory=self.cuda)
        self.events = [torch.cuda.Event() for _ in range(lag + 1)] if self.cuda else None
        self.taken = self.seen = 0
        self.last = [0, 0]

    def take(self) -> None:
        slot = self.taken % (self.lag + 1)
        self.host[slot].copy_(self.st, non_blocking=self.cuda)
        if self.cuda:
            self.events[slot].record()
        self.taken += 1

    def _read(self, i: int) -> None:
        slot = i % (self.lag + 1)
        with profiling.blocking("cg.loop"):
            if self.cuda:
                self.events[slot].synchronize()
            self.last = self.host[slot].tolist()

    def done(self) -> bool:
        """Whether the device had exited as of the copy `lag` behind the
        newest (False while there is none)."""
        if self.taken - self.seen <= self.lag:
            return False
        self._read(self.seen)
        self.seen += 1
        return bool(self.last[1])

    def iterations(self) -> int:
        """The device's iteration count once the host has stopped
        enqueueing (the newest copy's, unless an exit was seen)."""
        if not self.last[1]:
            self._read(self.taken - 1)
        return self.last[0]


def _cg(levels, b: torch.Tensor, a_scale, tol, max_iters, precond, x0=None) -> PressureResult:
    """Preconditioned CG with a fixed iteration bound. The early-out on tiny
    ||b||^2 (< 1e-6) skips the loop (read site ``cg.early_out``).

    An iteration is M^-1 r (the V-cycle, the mg16 cycle with its casts, or
    Jacobi), :func:`cg_direction` and :func:`cg_update`; CG's scalars and
    its exit test stay on the device, and the host reads the exit flag
    ``_EXIT_LAG`` iterations behind the queue (``cg.loop``), so up to that
    many iterations run after the exit, writing nothing (counter
    ``cg_iterations_skipped``). The iterations that change p, r and s are
    those of the unlagged loop. Counters: ``cg.kernel`` (CUDA tensors: the
    steps' kernels) or ``cg.plain`` (CPU tensors: their plain versions) per
    solve, ``cg_iterations`` the device's count."""
    lvl0 = levels[0]
    kernel = kernels.use_kernel(b)
    profiling.count("cg.kernel" if kernel else "cg.plain")
    if precond == "mg16":
        # bfloat16 copy of the hierarchy for the preconditioner sweeps (a
        # Hierarchy, which the fused kernels' wrappers check once a solve);
        # the outer CG iteration stays in b's dtype
        levels16 = multigrid.Hierarchy(
            multigrid.MGLevel(*[f.to(torch.bfloat16) for f in lev[:-1]], lev.scale)
            for lev in levels
        )

    def apply_M(r):
        """w with M^-1 r = w / m_scale: the cycles' output (m_scale =
        a_scale), or the Jacobi product (m_scale = 1)."""
        if precond == "mg16":
            return multigrid.v_cycle(levels16, r.to(torch.bfloat16)).to(r.dtype)
        if precond == "mg":
            return multigrid.v_cycle(levels, r)
        return lvl0.inv_diag / a_scale * r

    b2 = torch.sum(b * b)
    if not profiling.read(b2 >= 1e-6, "cg.early_out"):
        # the zero pressure of the cold start, not a stale warm start
        zero = torch.zeros((), dtype=b.dtype, device=b.device)
        return PressureResult(torch.zeros_like(b), zero, zero.to(torch.int32))
    if x0 is None:
        p = torch.zeros_like(b)
        r = b.clone()
    else:
        p = x0 * lvl0.fluid
        r = b - multigrid.apply_level(lvl0, p) * a_scale
    res = torch.amax(torch.abs(r)).reshape(1)
    scale = torch.as_tensor(a_scale, dtype=b.dtype, device=b.device).reshape(1)
    m_scale = scale if precond in ("mg", "mg16") else torch.ones_like(scale)
    sc = torch.cat((torch.zeros(2, dtype=b.dtype, device=b.device), res, scale, m_scale))
    st = torch.cat((torch.zeros(1, dtype=torch.int32, device=b.device), (~(res >= tol)).to(torch.int32)))
    s, q = torch.empty_like(b), torch.empty_like(b)
    part = torch.empty(_CG_PARTIALS, dtype=torch.float32, device=b.device) if kernel else None

    flags = _ExitFlags(st, _EXIT_LAG)
    flags.take()
    k = 0
    while k < max_iters and not flags.done():
        cg_direction(apply_M(r), r, s, q, lvl0, k == 0, sc, st, part)
        cg_update(p, r, s, q, sc, st, tol, max_iters, part)
        flags.take()
        k += 1
    it = flags.iterations()
    profiling.count("cg_iterations", it)
    profiling.count("cg_iterations_skipped", k - it)
    return PressureResult(pressure=p * lvl0.fluid, residual=sc[2], iterations=st[0])


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
        ADJOINT_SOLVES.append((profiling.read(adj.iterations, "cg.adjoint"),
                               profiling.read(adj.residual, "cg.adjoint")))
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
