"""Cell-index structure over the particle SoA (port of the ``Binning``
container of ``libfluid_tpu.sim.binning``)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Binning(NamedTuple):
    """Per-cell counts of the particle SoA.

    As produced by ``slotsort.sort_and_build`` the SoA is in RANK-major
    order, so only ``cell_of``/``cell_count``/``occupancy`` are meaningful;
    ``order``/``cell_start`` describe no cell-contiguous runs there.
    """

    order: torch.Tensor  # (N,) int32
    cell_of: torch.Tensor  # (N,) int32 flat cell id per particle (sentinel = num_cells)
    cell_start: torch.Tensor  # (C,) int32 exclusive prefix sum of cell_count
    cell_count: torch.Tensor  # (C,) int32 particles per cell
    occupancy: torch.Tensor  # (nx, ny, nz) int32 particles per cell
