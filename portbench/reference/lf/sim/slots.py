"""Dense per-cell particle slot grid (port of ``libfluid_tpu.sim.slots``).

The payload lives in one tensor ``data: (16, K, nx, ny, nz)``: 16 payload
columns, K slots per cell. A particle's slot index is plane-major,
``slot = rank * num_cells + cell``. Columns: position xyz (0:3), mask (3),
velocity xyz (4:7), APIC affine rows row-major (7:16).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.lf.config import SimConfig
from portbench.reference.lf.sim.binning import Binning

COL_POS = slice(0, 3)
COL_MASK = 3
COL_VEL = slice(4, 7)
COL_AFFINE = slice(7, 16)
WIDTH = 16


class SlotGrid(NamedTuple):
    data: torch.Tensor  # (16, K, nx, ny, nz) payload
    slot_of: torch.Tensor  # (N,) int32 plane-major slot index or sentinel K*num_cells
    overflow: torch.Tensor  # (N,) bool: active particle with rank >= K

    @property
    def capacity(self) -> int:
        return self.data.shape[1]

    @property
    def position(self) -> torch.Tensor:
        return self.data[COL_POS]  # (3, K, nx, ny, nz)

    @property
    def mask(self) -> torch.Tensor:
        return self.data[COL_MASK]  # (K, nx, ny, nz)

    @property
    def velocity(self) -> torch.Tensor:
        return self.data[COL_VEL]

    def affine_row(self, axis: int) -> torch.Tensor:
        """(3, K, nx, ny, nz) APIC affine row `axis`."""
        return self.data[7 + 3 * axis : 10 + 3 * axis]


def build(position: torch.Tensor, velocity: torch.Tensor, affine, bins: Binning,
          cfg: SimConfig) -> SlotGrid:
    """The slot grid of CELL-SORTED particle arrays (``binning.sort_by_cell``):
    each cell's particles are a contiguous run, so a particle's slot
    ``rank * num_cells + cell`` is unique and the build is one indexed write
    of one payload row per particle. `affine` None writes zero affine rows."""
    k = cfg.max_neighbors_per_cell
    n = position.shape[0]
    num_cells = cfg.num_cells
    dev = position.device

    cell = bins.cell_of  # sorted; sentinel num_cells for inactive
    in_grid = cell < num_cells
    rank = torch.arange(n, dtype=torch.int32, device=dev) - bins.cell_start[
        torch.clamp(cell, max=num_cells - 1).long()
    ]
    ok = in_grid & (rank < k)
    slot = torch.where(ok, rank * num_cells + cell, torch.full_like(cell, num_cells * k))

    aff = affine.reshape(n, 9) if affine is not None else position.new_zeros((n, 9))
    payload = torch.cat([position, position.new_ones((n, 1)), velocity, aff], dim=1)  # (N, 16)

    # row num_cells * k takes the rows without a slot and is dropped
    grid = position.new_zeros((num_cells * k + 1, WIDTH))
    grid[slot.long()] = payload
    nx, ny, nz = cfg.grid_size
    return SlotGrid(
        data=grid[:-1].t().reshape(WIDTH, k, nx, ny, nz),
        slot_of=slot,
        overflow=in_grid & (rank >= k),
    )


def gather_per_particle(values: torch.Tensor, slots: SlotGrid) -> torch.Tensor:
    """Read per-slot values (..., K, nx, ny, nz) back into per-particle order,
    (N, ...). Overflow/inactive particles read zeros."""
    lead = values.shape[:-4]
    kn = values.shape[-4] * values.shape[-3] * values.shape[-2] * values.shape[-1]
    flat = values.reshape(*lead, kn)
    flat = torch.cat([flat, flat.new_zeros((*lead, 1))], dim=-1)
    idx = torch.clamp(slots.slot_of, max=kn).long()
    out = flat[..., idx]  # (..., N)
    return torch.movedim(out, -1, 0) if lead else out


# The 27 cell-relative offsets shared by every dense neighborhood pass.
NEIGHBOR_OFFSETS = [
    (dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
]

