"""Dense per-cell particle slot grid (port of ``libfluid_tpu.sim.slots``).

The payload lives in one tensor ``data: (16, K, nx, ny, nz)``: 16 payload
columns, K slots per cell. A particle's slot index is plane-major,
``slot = rank * num_cells + cell``. Columns: position xyz (0:3), mask (3),
velocity xyz (4:7), APIC affine rows row-major (7:16).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from libfluid_tpu_torch.config import SimConfig

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


def shifted(arr: torch.Tensor, off, cfg: SimConfig) -> torch.Tensor:
    """Cells' view of neighbor cell ``c + off`` (grid dims are the LAST
    three), zero-padded at the domain boundary."""
    nx, ny, nz = cfg.grid_size
    p = F.pad(arr, (1, 1, 1, 1, 1, 1))
    ox, oy, oz = off
    return p[
        ...,
        1 + ox : 1 + ox + nx,
        1 + oy : 1 + oy + ny,
        1 + oz : 1 + oz + nz,
    ]
