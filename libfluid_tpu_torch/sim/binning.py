"""Sort-based particle binning and fixed-capacity neighbour gathers (port of
``libfluid_tpu.sim.binning``).

A stable argsort by cell id plus per-cell start offsets give each cell's
particles as a contiguous run of ``order``; inactive particles are keyed to
a sentinel cell past the end, so they sit in no neighbourhood. The substep
itself bins through ``slotsort`` (rank-major order); these functions serve
the z-sharded substep (``parallel.zshard``), which builds its slot grid from
cell-sorted rows with :func:`libfluid_tpu_torch.sim.slots.build`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from libfluid_tpu_torch import grids, profiling
from libfluid_tpu_torch.config import SimConfig


class Binning(NamedTuple):
    """Per-cell counts of the particle SoA.

    From :func:`bin_particles` / :func:`sort_by_cell`, ``order`` and
    ``cell_start`` describe cell-contiguous runs. As produced by
    ``slotsort.sort_and_build`` the SoA is in RANK-major order, so only
    ``cell_of``/``cell_count``/``occupancy`` are meaningful there.
    """

    order: torch.Tensor  # (N,) particle ids sorted by cell
    cell_of: torch.Tensor  # (N,) int32 flat cell id per particle (sentinel = num_cells)
    cell_start: torch.Tensor  # (C,) int32 exclusive prefix sum of cell_count
    cell_count: torch.Tensor  # (C,) int32 particles per cell
    occupancy: torch.Tensor  # (nx, ny, nz) int32 particles per cell


def bin_particles(position: torch.Tensor, active: torch.Tensor, cfg: SimConfig) -> Binning:
    """Cell ids, a stable cell-sorted order and per-cell runs of the SoA."""
    num_cells = cfg.num_cells
    cell = grids.flat_cell_index(grids.cell_index_of(position, cfg), cfg)
    cell = torch.where(active, cell, torch.full_like(cell, num_cells))
    # stable, as jnp.argsort: equal cells keep their row order
    order = torch.argsort(cell, stable=True).to(torch.int32)
    with profiling.blocking("binning.bincount"):  # on the card, reads cell's bounds back
        counts = torch.bincount(cell, minlength=num_cells + 1)[:num_cells].to(torch.int32)
    cell_start = torch.cumsum(counts, dim=0, dtype=torch.int32) - counts
    return Binning(
        order=order, cell_of=cell, cell_start=cell_start, cell_count=counts,
        occupancy=counts.reshape(cfg.grid_size),
    )


def sort_by_cell(state, cfg: SimConfig):
    """Bin and reorder the particle SoA into cell order. Returns (state,
    bins) with the particle arrays permuted and ``bins.order`` the
    identity."""
    bins = bin_particles(state.position, state.active, cfg)
    o = bins.order.long()
    n = o.shape[0]
    cell_sorted = bins.cell_of[o]
    state = state._replace(
        position=state.position[o],
        velocity=state.velocity[o],
        affine=state.affine[o],
        # inactive rows were keyed to the sentinel cell
        active=cell_sorted < cfg.num_cells,
    )
    return state, bins._replace(
        order=torch.arange(n, dtype=torch.int32, device=o.device), cell_of=cell_sorted
    )


def gather_neighbors(
    binning: Binning, position: torch.Tensor, cfg: SimConfig, max_per_cell: Optional[int] = None
):
    """Candidate neighbour ids of every particle from its 3x3x3 cell
    neighbourhood, the first `max_per_cell` of each cell in cell-sorted
    order. Returns (ids, valid), each (N, 27 * max_per_cell); `valid` masks
    slots past a cell's count and cells outside the grid."""
    k = cfg.max_neighbors_per_cell if max_per_cell is None else max_per_cell
    dev = position.device
    dims = torch.tensor(cfg.grid_size, dtype=torch.int32, device=dev)
    idx3 = grids.cell_index_of(position, cfg)
    slot = torch.arange(k, dtype=torch.int32, device=dev)[None, :]
    last = binning.order.shape[0] - 1

    ids_all, valid_all = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                n3 = idx3 + torch.tensor([dx, dy, dz], dtype=torch.int32, device=dev)
                inb = torch.all((n3 >= 0) & (n3 < dims), dim=-1)
                c = grids.flat_cell_index(torch.clamp(n3, min=0), cfg)
                c = torch.clamp(c, 0, cfg.num_cells - 1).long()
                start = binning.cell_start[c]
                count = binning.cell_count[c]
                pos_in_order = torch.clamp(start[:, None] + slot, 0, last).long()
                ids_all.append(binning.order[pos_in_order])
                valid_all.append(inb[:, None] & (slot < count[:, None]))
    return torch.cat(ids_all, dim=1), torch.cat(valid_all, dim=1)
