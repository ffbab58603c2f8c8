"""Particle/solid collision response (port of ``libfluid_tpu.sim.collisions``,
the obstacle-free branch)."""

from __future__ import annotations

import torch

from libfluid_tpu_torch.config import SimConfig


def resolve_collisions(
    old_position: torch.Tensor,
    position: torch.Tensor,
    solid: torch.Tensor,
    cfg: SimConfig,
) -> torch.Tensor:
    """Push particles a skin width off the domain walls.

    With ``cfg.has_obstacles=False`` there are no interior solid cells, so
    the segment march can never hit (advection already clamps into the
    domain) and the skin push-out engages only against the six walls.
    """
    if cfg.has_obstacles:
        raise NotImplementedError(
            "collisions with obstacles (the exact DDA march) are not ported yet "
            "(ROADMAP: DDA collisions, seed_sources, PIC/FLIP and mg16); "
            "set has_obstacles=False"
        )
    h = cfg.cell_size
    skin = cfg.boundary_skin_width
    dev = position.device
    gpos = position - torch.tensor(cfg.grid_offset, dtype=position.dtype, device=dev)
    dims = torch.tensor(cfg.grid_size, dtype=torch.int32, device=dev)
    cell_idx = torch.floor(gpos / h).to(torch.int32)
    cell_idx = torch.minimum(torch.clamp(cell_idx, min=0), dims - 1)
    cell_pos = gpos - cell_idx.to(position.dtype) * h
    cell_skin_max = h - skin
    neg_blocked = cell_idx == 0
    pos_blocked = cell_idx + 1 >= dims
    zero = torch.zeros_like(cell_pos)
    d = torch.where((cell_pos < skin) & neg_blocked, skin - cell_pos, zero)
    d = d + torch.where(
        (cell_pos > cell_skin_max) & pos_blocked, cell_skin_max - cell_pos, zero
    )
    return position + d
