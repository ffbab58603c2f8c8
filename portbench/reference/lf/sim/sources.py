"""Fluid sources: per-step seeding and velocity coercion (port of
``libfluid_tpu.sim.sources``).

Each active source cell is topped back up to its target density every
substep: the cell proposes MAX_SEED_PER_CELL candidates at uniform random
positions inside it, accepts as many as its deficit, and the accepted
candidates take free SoA slots in order (rank-matched cumulative sums, no
host round trip). Excess candidates are dropped when the capacity is full.
The deterministic part, :func:`seed_from_jitter`, takes the candidates'
random offsets as an argument: the substep passes those of its
:class:`step.Draws`, and the tests JAX's own draw.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.lf import grids
from portbench.reference.lf.config import SimConfig, resolve_device
from portbench.reference.lf.sim.state import SimState, SourceSet

MAX_SEED_PER_CELL = 8  # = default seeding density 2^3


def coerce_velocities(state: SimState, cfg: SimConfig) -> SimState:
    """Set velocity (and zero the APIC matrix) of particles inside active
    coercing source cells."""
    src = state.sources
    if src.cells.shape[0] == 0:
        return state
    cell = grids.flat_cell_index(grids.cell_index_of(state.position, cfg), cfg)
    src_flat = grids.flat_cell_index(src.cells, cfg)
    coercing = src.active & src.coerce_velocity  # (S,)
    match = (cell[:, None] == src_flat[None, :]) & coercing[None, :]  # (N, S)
    any_match = torch.any(match, dim=1) & state.active
    src_id = torch.argmax(match.to(torch.int8), dim=1)  # first matching source
    vel = torch.where(any_match[:, None], src.velocity[src_id], state.velocity)
    affine = torch.where(
        any_match[:, None, None], torch.zeros_like(state.affine), state.affine
    )
    return state._replace(velocity=vel, affine=affine)


def seed_from_jitter(
    state: SimState, occupancy: torch.Tensor, cfg: SimConfig, jitter: torch.Tensor
) -> SimState:
    """Top every active source cell back up to its target density, with the
    candidates' in-cell offsets `jitter` (S, MAX_SEED_PER_CELL, 3), uniform
    in [0, h)."""
    src = state.sources
    s = src.cells.shape[0]
    if s == 0:
        return state
    dev = state.position.device
    cells = src.cells.long()
    counts = occupancy[cells[:, 0], cells[:, 1], cells[:, 2]]
    target = torch.clamp(src.target_density**3, max=MAX_SEED_PER_CELL)
    deficit = torch.where(src.active, torch.clamp(target - counts, min=0), torch.zeros_like(target))

    off = torch.tensor(cfg.grid_offset, dtype=cfg.dtype, device=dev)
    jitter = jitter.to(dev)
    cand_pos = (off + src.cells[:, None, :].to(cfg.dtype) * cfg.cell_size + jitter).reshape(-1, 3)
    cand_vel = src.velocity[:, None, :].expand(s, MAX_SEED_PER_CELL, 3).reshape(-1, 3)
    slot_in_cell = torch.arange(MAX_SEED_PER_CELL, device=dev).repeat(s)
    accepted = slot_in_cell < torch.repeat_interleave(deficit, MAX_SEED_PER_CELL)
    n_accepted = accepted.sum(dtype=torch.int32)

    # rank-match accepted candidates to free slots
    n_cand = accepted.shape[0]
    cand_rank = torch.cumsum(accepted.to(torch.int32), dim=0) - 1
    scatter_idx = torch.where(accepted, cand_rank, torch.full_like(cand_rank, n_cand)).long()
    cand_by_rank = torch.zeros((n_cand + 1,), dtype=torch.int64, device=dev)
    cand_by_rank[scatter_idx] = torch.arange(n_cand, device=dev)
    cand_by_rank = cand_by_rank[:-1]

    free = ~state.active
    free_rank = torch.cumsum(free.to(torch.int32), dim=0) - 1
    take = free & (free_rank < n_accepted)
    cid = cand_by_rank[torch.clamp(free_rank, 0, n_cand - 1).long()]

    return state._replace(
        position=torch.where(take[:, None], cand_pos[cid], state.position),
        velocity=torch.where(take[:, None], cand_vel[cid], state.velocity),
        affine=torch.where(take[:, None, None], torch.zeros_like(state.affine), state.affine),
        active=state.active | take,
    )


def source_jitter(generator: torch.Generator, s: int, cfg: SimConfig) -> torch.Tensor:
    """(S, MAX_SEED_PER_CELL, 3) uniform in [0, h) from a CPU generator."""
    u = torch.rand((s, MAX_SEED_PER_CELL, 3), generator=generator, dtype=cfg.dtype)
    return u * cfg.cell_size


def seed_sources(state: SimState, occupancy: torch.Tensor, cfg: SimConfig) -> SimState:
    """Top every active source cell back up to its target density, with
    candidates drawn from the state's generator."""
    s = state.sources.cells.shape[0]
    if s == 0:
        return state
    return seed_from_jitter(state, occupancy, cfg, source_jitter(state.generator, s, cfg))


def make_source_set(
    cells, velocity, active=True, coerce_velocity=False, target_density=2, device=None
) -> SourceSet:
    """A SourceSet on `device` (None: the CUDA card) from host data; `cells`
    is (S, 3) int, `velocity` either (3,) shared or (S, 3)."""
    device = resolve_device(device)
    cells = np.asarray(cells, np.int32).reshape(-1, 3)
    s = cells.shape[0]
    vel = np.broadcast_to(np.asarray(velocity, np.float32), (s, 3))

    def t(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    return SourceSet(
        cells=t(cells, torch.int32),
        velocity=t(vel, torch.float32),
        active=t(np.broadcast_to(active, (s,)), torch.bool),
        coerce_velocity=t(np.broadcast_to(coerce_velocity, (s,)), torch.bool),
        target_density=t(np.broadcast_to(target_density, (s,)), torch.int32),
    )
