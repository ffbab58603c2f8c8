"""Fluid sources: velocity coercion (port of ``coerce_velocities`` of
``libfluid_tpu.sim.sources``). Per-step seeding (``seed_sources``) is not
ported yet, so ``step.substep`` refuses a state with sources."""

from __future__ import annotations

import torch

from libfluid_tpu_torch import grids
from libfluid_tpu_torch.config import SimConfig
from libfluid_tpu_torch.sim.state import SimState


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
