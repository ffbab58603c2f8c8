"""Velocity extrapolation from fluid cells into the surrounding air (port of
``libfluid_tpu.sim.extrapolation``).

k sweeps of breadth-first neighbor averaging over a cell-centred view of the
positive faces. An invalid cell with a valid 6-neighbor takes the average of
its valid neighbors and becomes valid, but component `dim` is written only
where the positive neighbor in `dim` is valid and of the same cell type: an
air->fluid face holds a freshly projected velocity that must not be
overwritten. An out-of-bounds neighbor counts as SOLID and invalid.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from libfluid_tpu_torch import grids
from libfluid_tpu_torch.config import CellType, SimConfig


def _neighbor_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of the 6 face-neighbor values, zero-padded, along the TRAILING 3
    axes."""
    xp = F.pad(x, (1, 1, 1, 1, 1, 1))
    m = slice(1, -1)

    def sl(a, b, c):
        return xp[..., a, b, c]

    return (
        sl(slice(None, -2), m, m)
        + sl(slice(2, None), m, m)
        + sl(m, slice(None, -2), m)
        + sl(m, slice(2, None), m)
        + sl(m, m, slice(None, -2))
        + sl(m, m, slice(2, None))
    )


def _shift_neg(x: torch.Tensor, axis: int, fill) -> torch.Tensor:
    """x shifted by -1 along `axis` (value of the positive neighbor), padding
    with `fill`."""
    edge = torch.full_like(x.narrow(axis, 0, 1), fill)
    return torch.cat([x.narrow(axis, 1, x.shape[axis] - 1), edge], dim=axis)


def extrapolate(grid: grids.MacGrid, cfg: SimConfig) -> grids.MacGrid:
    iters = cfg.velocity_extrapolation_iterations
    if iters <= 0:
        return grid

    # component-major positive-face view: vel[c,i,j,k] = (u[i+1], v[j+1], w[k+1])[c]
    vel = torch.stack([grid.u[1:, :, :], grid.v[:, 1:, :], grid.w[:, :, 1:]], dim=0)
    ct = grid.cell_type
    valid = (ct == CellType.FLUID).to(cfg.dtype)
    nb_type_same = [_shift_neg(ct, dim, CellType.SOLID) == ct for dim in range(3)]

    for _ in range(iters):
        nsum = _neighbor_sum(vel * valid[None])
        ncount = _neighbor_sum(valid)
        has = ncount > 0
        avg = nsum / torch.clamp(ncount, min=1.0)[None]
        newly = (valid == 0) & has
        write = torch.stack(
            [
                newly & (_shift_neg(valid, dim, 0.0) > 0) & nb_type_same[dim]
                for dim in range(3)
            ],
            dim=0,
        )
        vel = torch.where(write, avg, vel)
        valid = torch.where(newly, torch.ones_like(valid), valid)

    u, v, w = grid.u.clone(), grid.v.clone(), grid.w.clone()
    u[1:, :, :] = vel[0]
    v[:, 1:, :] = vel[1]
    w[:, :, 1:] = vel[2]
    return grid._replace(u=u, v=v, w=w)
