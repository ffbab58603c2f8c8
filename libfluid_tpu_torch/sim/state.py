"""Simulation state and particle seeding (PyTorch port of
``libfluid_tpu.sim.state``).

Particles are SoA tensors of a fixed capacity with an ``active`` mask, as in
the JAX package. Seeding runs on the host with numpy and draws the same
numbers as the JAX package from the same ``np.random.Generator``, so both
packages seed identical particles.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from libfluid_tpu_torch import grids
from libfluid_tpu_torch.config import CellType, SimConfig


class SourceSet(NamedTuple):
    """Flattened fluid sources; zero-length tensors mean "no sources"."""

    cells: torch.Tensor  # (S, 3) int32 cell indices
    velocity: torch.Tensor  # (S, 3) seed velocity
    active: torch.Tensor  # (S,) bool
    coerce_velocity: torch.Tensor  # (S,) bool
    target_density: torch.Tensor  # (S,) int32 cube root of particles per cell


def empty_sources(device=None) -> SourceSet:
    return SourceSet(
        cells=torch.zeros((0, 3), dtype=torch.int32, device=device),
        velocity=torch.zeros((0, 3), dtype=torch.float32, device=device),
        active=torch.zeros((0,), dtype=torch.bool, device=device),
        coerce_velocity=torch.zeros((0,), dtype=torch.bool, device=device),
        target_density=torch.zeros((0,), dtype=torch.int32, device=device),
    )


class SimState(NamedTuple):
    """The complete simulation state: advances via ``step(state, cfg, dt)``."""

    position: torch.Tensor  # (N, 3)
    velocity: torch.Tensor  # (N, 3)
    affine: torch.Tensor  # (N, 3, 3) APIC C matrix, rows per velocity component
    active: torch.Tensor  # (N,) bool
    grid: grids.MacGrid
    solid: torch.Tensor  # (nx, ny, nz) bool static solid geometry
    sources: SourceSet
    generator: Optional[torch.Generator]  # for future on-device randomness
    time: torch.Tensor  # scalar accumulated sim time
    pressure: torch.Tensor  # (nx, ny, nz) last substep's pressure (CG warm start)


def new_state(
    cfg: SimConfig, device=None, generator: Optional[torch.Generator] = None
) -> SimState:
    n = cfg.particle_capacity
    dt = cfg.dtype
    return SimState(
        position=torch.zeros((n, 3), dtype=dt, device=device),
        velocity=torch.zeros((n, 3), dtype=dt, device=device),
        affine=torch.zeros((n, 3, 3), dtype=dt, device=device),
        active=torch.zeros((n,), dtype=torch.bool, device=device),
        grid=grids.zeros(cfg, device),
        solid=torch.zeros(cfg.grid_size, dtype=torch.bool, device=device),
        sources=empty_sources(device),
        generator=generator,
        time=torch.zeros((), dtype=dt, device=device),
        pressure=torch.zeros(cfg.grid_size, dtype=dt, device=device),
    )


def particle_count(state: SimState) -> torch.Tensor:
    return state.active.sum(dtype=torch.int32)


def set_solid(state: SimState, solid_mask) -> SimState:
    """Install a solid-cell mask and mark those cells in the grid."""
    solid = torch.as_tensor(solid_mask, dtype=torch.bool, device=state.solid.device)
    ct = state.grid.cell_type.clone()
    ct[~solid & (ct == CellType.SOLID)] = CellType.AIR
    ct[solid] = CellType.SOLID
    return state._replace(solid=solid, grid=state.grid._replace(cell_type=ct))


# ---------------------------------------------------------------------------
# Host-side seeding (setup time)
# ---------------------------------------------------------------------------


def _insert_particles(state: SimState, pos: np.ndarray, vel: np.ndarray) -> SimState:
    """Place host-generated particles into free slots of the SoA arrays."""
    if pos.shape[0] == 0:
        return state
    active = state.active.cpu().numpy().copy()
    free = np.flatnonzero(~active)
    if pos.shape[0] > free.size:
        raise ValueError(
            f"particle capacity exceeded: need {pos.shape[0]} free slots, have {free.size}"
        )
    slots = free[: pos.shape[0]]
    position = state.position.cpu().numpy().copy()
    velocity = state.velocity.cpu().numpy().copy()
    affine = state.affine.cpu().numpy().copy()
    position[slots] = pos
    velocity[slots] = vel
    affine[slots] = 0.0
    active[slots] = True
    device = state.position.device
    return state._replace(
        position=torch.from_numpy(position).to(device),
        velocity=torch.from_numpy(velocity).to(device),
        affine=torch.from_numpy(affine).to(device),
        active=torch.from_numpy(active).to(device),
    )


def seed_func(
    state: SimState,
    cfg: SimConfig,
    start_cell: Tuple[int, int, int],
    cell_count: Tuple[int, int, int],
    predicate: Callable[[np.ndarray], np.ndarray],
    velocity=(0.0, 0.0, 0.0),
    density: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
) -> SimState:
    """Seed `density`^3 jittered particles per cell in a cell range, filtered
    by a world-space predicate over positions."""
    density = cfg.seeding_density if density is None else density
    rng = np.random.default_rng(0) if rng is None else rng
    h = cfg.cell_size
    off = np.asarray(cfg.grid_offset)
    sx, sy, sz = start_cell
    cx, cy, cz = cell_count
    gx, gy, gz = cfg.grid_size
    xs = np.arange(max(sx, 0), min(sx + cx, gx))
    ys = np.arange(max(sy, 0), min(sy + cy, gy))
    zs = np.arange(max(sz, 0), min(sz + cz, gz))
    if xs.size == 0 or ys.size == 0 or zs.size == 0:
        return state
    cells = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), axis=-1).reshape(-1, 3)
    per_cell = density ** 3
    jitter = rng.uniform(0.0, h, size=(cells.shape[0], per_cell, 3))
    pos = off + cells[:, None, :] * h + jitter
    pos = pos.reshape(-1, 3)
    keep = np.asarray(predicate(pos), bool)
    pos = pos[keep]
    vel = np.broadcast_to(np.asarray(velocity, np.float64), pos.shape).copy()
    return _insert_particles(state, pos, vel)


def seed_box(
    state: SimState,
    cfg: SimConfig,
    start,
    size,
    velocity=(0.0, 0.0, 0.0),
    density: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
) -> SimState:
    """Seed a world-space axis-aligned box."""
    start = np.asarray(start, np.float64)
    end = start + np.asarray(size, np.float64)
    off = np.asarray(cfg.grid_offset)
    start_cell = np.maximum(np.floor((start - off) / cfg.cell_size), 0).astype(int)
    end_cell = np.maximum(np.floor((end - off) / cfg.cell_size), 0).astype(int)
    return seed_func(
        state,
        cfg,
        tuple(start_cell),
        tuple(end_cell - start_cell + 1),
        lambda p: np.all((p > start) & (p < end), axis=-1),
        velocity,
        density,
        rng,
    )


def seed_sphere(
    state: SimState,
    cfg: SimConfig,
    center,
    radius: float,
    velocity=(0.0, 0.0, 0.0),
    density: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
) -> SimState:
    """Seed a world-space sphere."""
    center = np.asarray(center, np.float64)
    off = np.asarray(cfg.grid_offset)
    start_cell = np.maximum(
        np.floor((center - radius - off) / cfg.cell_size), 0
    ).astype(int)
    end_cell = np.maximum(
        np.floor((center + radius - off) / cfg.cell_size), 0
    ).astype(int)
    return seed_func(
        state,
        cfg,
        tuple(start_cell),
        tuple(end_cell - start_cell + 1),
        lambda p: np.sum((p - center) ** 2, axis=-1) < radius * radius,
        velocity,
        density,
        rng,
    )
