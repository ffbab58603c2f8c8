"""The simulation time step (port of ``libfluid_tpu.sim.step``).

Stage order of one substep:

    advect (+ source velocity coercion) -> collide -> sort + slot grid ->
    seed sources (+ re-sort) -> P2G + mark cells -> gravity ->
    pressure solve -> apply pressure -> position correction -> collide ->
    extrapolate -> G2P

``step`` runs the CFL substep loop on the host: substep size
cfl_number * h / max|v|, iterated until dt is consumed.

``substep`` is differentiable with ``torch.autograd`` as the JAX package's
is with ``jax.grad``: every stage that holds a kernel is an autograd
Function whose backward follows the JAX package's ``custom_vjp`` (P2G and
G2P through the adjoint kernels B' and D', the pressure solve through one
adjoint CG solve, the DDA march straight through). ``step`` stays
forward-only, as in the JAX package, whose CFL loop is a
``lax.while_loop``.

A substep's random numbers (the sources' candidate positions, then the
correction's jitter seed, in the order in which the JAX package splits its
key) come from one :class:`Draws` object: by default the state's CPU
generator. Tests pass an object with the same two methods that hands out
the JAX package's values.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from libfluid_tpu_torch import grids
from libfluid_tpu_torch.config import SimConfig, TransferScheme
from libfluid_tpu_torch.sim import collisions as collisions_mod
from libfluid_tpu_torch.sim import correction as correction_mod
from libfluid_tpu_torch.sim import extrapolation as extrapolation_mod
from libfluid_tpu_torch.sim import jitterhash
from libfluid_tpu_torch.sim import pressure as pressure_mod
from libfluid_tpu_torch.sim import slotsort
from libfluid_tpu_torch.sim import sources as sources_mod
from libfluid_tpu_torch.sim import transfers
from libfluid_tpu_torch.sim.state import SimState


class Diagnostics(NamedTuple):
    """Per-step observability; scalars are 0-dim tensors on the state's device."""

    kinetic_energy: torch.Tensor
    potential_energy: torch.Tensor
    max_velocity: torch.Tensor
    pressure_iterations: torch.Tensor
    pressure_residual: torch.Tensor
    max_pressure: torch.Tensor
    max_divergence: torch.Tensor  # post-projection; should be ~0
    particle_count: torch.Tensor
    substeps: torch.Tensor
    overflow_count: torch.Tensor  # particles past the slot capacity (merged exactly by P2G)
    # particles deactivated this step: always 0 here (the JAX package's
    # sharded exchange can lose particles; the dense path cannot)
    particles_lost: torch.Tensor
    # slot-overflow particles beyond correction_overflow_capacity this
    # substep: they received no correction spring (every other stage still
    # handles them); nonzero means the cap is undersized for the scene
    correction_uncorrected: torch.Tensor


class Draws:
    """The random numbers of a substep, drawn from a CPU generator (the
    state's by default). A stand-in for tests needs the same two methods."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def source_jitter(self, s: int, cfg: SimConfig) -> torch.Tensor:
        """(S, MAX_SEED_PER_CELL, 3) in-cell offsets of the source candidates."""
        return sources_mod.source_jitter(self.generator, s, cfg)

    def correction_seed(self) -> int:
        """The jitter seed of the correction springs."""
        return jitterhash.seed_from_key(self.generator)


def cfl_dt(state: SimState, cfg: SimConfig) -> torch.Tensor:
    """h / max|v| over active particles (+inf for an all-still state)."""
    sq = torch.sum(state.velocity**2, dim=-1)
    sq = torch.where(state.active, sq, torch.zeros_like(sq))
    vmax = torch.sqrt(torch.amax(sq))
    return cfg.cell_size / torch.clamp(vmax, min=1e-30)


def _advect(state: SimState, cfg: SimConfig, dt) -> SimState:
    """Forward-Euler advection + clamp into the skin-shrunk domain."""
    state = sources_mod.coerce_velocities(state, cfg)
    skin = cfg.boundary_skin_width
    dev = state.position.device
    lo = torch.tensor(cfg.domain_min, dtype=cfg.dtype, device=dev) + skin
    hi = torch.tensor(cfg.domain_max, dtype=cfg.dtype, device=dev) - skin
    pos = state.position + state.velocity * dt
    pos = torch.minimum(torch.maximum(pos, lo), hi)
    pos = torch.where(state.active[:, None], pos, state.position)
    return state._replace(position=pos)


def _add_gravity(grid: grids.MacGrid, cfg: SimConfig, dt) -> grids.MacGrid:
    """Add g*dt to every face but the min walls (index 0)."""
    g = torch.tensor(cfg.gravity, dtype=cfg.dtype, device=grid.u.device) * dt
    u, v, w = grid.u.clone(), grid.v.clone(), grid.w.clone()
    u[1:] += g[0]
    v[:, 1:] += g[1]
    w[:, :, 1:] += g[2]
    return grid._replace(u=u, v=v, w=w)


def _collide(state: SimState, old_position: torch.Tensor, cfg: SimConfig) -> SimState:
    if not cfg.enable_collisions:
        return state
    pos = collisions_mod.resolve_collisions(old_position, state.position, state.solid, cfg)
    return state._replace(position=torch.where(state.active[:, None], pos, state.position))


def substep(
    state: SimState, cfg: SimConfig, dt, draws: Optional[Draws] = None
) -> Tuple[SimState, Diagnostics]:
    """One full time step of size dt (CFL-bounding is the caller's job).
    `draws` supplies the random numbers (default: the state's generator)."""
    draws = Draws(state.generator) if draws is None else draws
    dev = state.position.device
    dt = torch.as_tensor(dt, dtype=cfg.dtype, device=dev)

    # --- advection + collisions ---
    old_position = state.position
    state = _collide(_advect(state, cfg, dt), old_position, cfg)

    # --- sort into rank-major slot order + slot grid; seeding sources
    # re-sorts ---
    sb = slotsort.sort_and_build(state, cfg)
    n_src = state.sources.cells.shape[0]
    if n_src > 0:
        state = sources_mod.seed_from_jitter(
            sb.state, sb.bins.occupancy, cfg, draws.source_jitter(n_src, cfg)
        )
        sb = slotsort.sort_and_build(state, cfg)
    state, bins, slot_grid = sb.state, sb.bins, sb.slot_grid
    old_position = state.position

    # --- P2G + cell marking ---
    u, v, w = transfers.p2g_slots(
        slot_grid, state.position, state.velocity, state.affine,
        state.active, cfg, overflow_start=sb.n_kept,
    )
    grid = grids.mark_cells(state.grid._replace(u=u, v=v, w=w), bins.occupancy)
    old_grid = None
    if cfg.scheme == TransferScheme.APIC:
        grid = grids.remove_boundary_normal_velocities(grid)
    elif cfg.scheme == TransferScheme.FLIP:
        old_grid = grids.remove_boundary_normal_velocities(grid)

    # --- gravity, then pressure projection warm-started from the last substep ---
    grid = _add_gravity(grid, cfg, dt)
    pres = pressure_mod.solve(grid, cfg, dt, x0=state.pressure)
    grid = pressure_mod.apply_pressure(grid, pres.pressure, cfg, dt)

    # --- position correction + collisions ---
    corr_uncorrected = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.enable_position_correction:
        seed = draws.correction_seed()
        # rank >= kc rows start right after the kept rows of the lower rank
        # segments (the slot order is rank-major)
        kc = min(cfg.correction_capacity, slot_grid.capacity)
        trunc_start = torch.sum(torch.clamp(bins.cell_count, max=kc), dtype=torch.int32)
        n_trunc = torch.sum(state.active & (slot_grid.slot_of >= kc * cfg.num_cells), dtype=torch.int32)
        corr_uncorrected = torch.clamp(n_trunc - cfg.correction_overflow_capacity, min=0)
        pos = correction_mod.correct_positions(
            state.position, state.active, slot_grid, cfg, dt, seed, trunc_start=trunc_start,
        )
        state = state._replace(position=pos)
    state = _collide(state, old_position, cfg)

    # --- velocity extrapolation + G2P ---
    grid = extrapolation_mod.extrapolate(grid, cfg)
    if cfg.scheme == TransferScheme.FLIP:
        vel = transfers.g2p_flip(grid, old_grid, state.position, state.velocity, cfg)
        affine = state.affine
    else:
        vel, affine = transfers.g2p_pic(grid, state.position, cfg)
        if cfg.scheme == TransferScheme.PIC:
            affine = state.affine
    vel = torch.where(state.active[:, None], vel, state.velocity)
    affine = torch.where(state.active[:, None, None], affine, state.affine)

    state = state._replace(
        velocity=vel, affine=affine, grid=grid, time=state.time + dt,
        pressure=pres.pressure,
    )

    # --- diagnostics ---
    active_f = state.active.to(cfg.dtype)
    vsq = torch.sum(vel**2, dim=-1) * active_f
    g = torch.tensor(cfg.gravity, dtype=cfg.dtype, device=dev)
    diag = Diagnostics(
        kinetic_energy=0.5 * torch.sum(vsq),
        potential_energy=-torch.sum(torch.sum(state.position * g, dim=-1) * active_f),
        max_velocity=torch.sqrt(torch.amax(vsq)),
        pressure_iterations=pres.iterations,
        pressure_residual=pres.residual,
        max_pressure=torch.amax(torch.abs(pres.pressure)),
        max_divergence=torch.amax(
            torch.abs(pressure_mod.compute_rhs(grid, cfg) * cfg.cell_size)
        ),
        particle_count=state.active.sum(dtype=torch.int32),
        substeps=torch.tensor(1, dtype=torch.int32, device=dev),
        overflow_count=slot_grid.overflow.sum(dtype=torch.int32),
        particles_lost=torch.zeros((), dtype=torch.int32, device=dev),
        correction_uncorrected=corr_uncorrected,
    )
    return state, diag


def step(
    state: SimState, cfg: SimConfig, dt, draws: Optional[Draws] = None
) -> Tuple[SimState, Diagnostics]:
    """Advance by dt with CFL substepping. Returns the diagnostics of the last
    substep with the substep count filled in; the loop reads the remaining
    time on the host once per substep. Every substep takes its random
    numbers from `draws` (default: the state's generator)."""
    dev = state.position.device
    remaining = torch.as_tensor(dt, dtype=cfg.dtype, device=dev)
    diag = None
    nsub = 0
    while bool(remaining > 0.0):
        ts = torch.minimum(cfg.cfl_number * cfl_dt(state, cfg), remaining)
        state, diag = substep(state, cfg, ts, draws)
        remaining = remaining - ts
        nsub += 1
    if diag is None:
        zero = torch.zeros((), dtype=cfg.dtype, device=dev)
        izero = torch.zeros((), dtype=torch.int32, device=dev)
        diag = Diagnostics(zero, zero, zero, izero, zero, zero, zero, izero, izero, izero, izero, izero)
    return state, diag._replace(substeps=torch.tensor(nsub, dtype=torch.int32, device=dev))
