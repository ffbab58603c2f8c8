"""MAC (marker-and-cell) staggered grid as a tuple of dense tensors (port of
``libfluid_tpu.grids``).

The layout is that of ``libfluid_tpu.grids``:

    u: (nx+1, ny, nz)   x-face normal velocities; u[i] is the face between
                        cells i-1 and i (u[0]/u[nx] are the domain walls)
    v: (nx, ny+1, nz)
    w: (nx, ny, nz+1)
    cell_type: (nx, ny, nz) int8, values from :class:`CellType`
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from portbench.reference.lf.config import CellType, SimConfig, resolve_device


class MacGrid(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    cell_type: torch.Tensor

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        return tuple(self.cell_type.shape)


def zeros(cfg: SimConfig, device=None) -> MacGrid:
    """An all-air grid at rest on `device` (None: the CUDA card)."""
    device = resolve_device(device)
    nx, ny, nz = cfg.grid_size
    dt = cfg.dtype
    return MacGrid(
        u=torch.zeros((nx + 1, ny, nz), dtype=dt, device=device),
        v=torch.zeros((nx, ny + 1, nz), dtype=dt, device=device),
        w=torch.zeros((nx, ny, nz + 1), dtype=dt, device=device),
        cell_type=torch.full(
            (nx, ny, nz), CellType.AIR, dtype=torch.int8, device=device
        ),
    )


def _offset(cfg: SimConfig, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(cfg.grid_offset, dtype=like.dtype, device=like.device)


def face_index_coords(pos: torch.Tensor, cfg: SimConfig, axis: int) -> torch.Tensor:
    """World position -> float index coordinates into the `axis` face array
    (a u-face sample (i,j,k) sits at offset + h*(i, j+0.5, k+0.5))."""
    g = (pos - _offset(cfg, pos)) / cfg.cell_size
    shift = torch.full((3,), 0.5, dtype=pos.dtype, device=pos.device)
    shift[axis] = 0.0
    return g - shift


def _gather_trilerp_zero_pad(arr: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of `arr` at float index coordinates (..., 3); samples
    whose integer index falls outside the array read as 0."""
    base_f = torch.floor(coords)
    frac = coords - base_f
    base = base_f.to(torch.int64)
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ix, iy, iz = base[..., 0] + dx, base[..., 1] + dy, base[..., 2] + dz
                inb = (
                    (ix >= 0) & (ix < arr.shape[0]) & (iy >= 0) & (iy < arr.shape[1])
                    & (iz >= 0) & (iz < arr.shape[2])
                )
                sample = arr[
                    torch.clamp(ix, 0, arr.shape[0] - 1),
                    torch.clamp(iy, 0, arr.shape[1] - 1),
                    torch.clamp(iz, 0, arr.shape[2] - 1),
                ]
                wgt = (
                    (frac[..., 0] if dx else 1.0 - frac[..., 0])
                    * (frac[..., 1] if dy else 1.0 - frac[..., 1])
                    * (frac[..., 2] if dz else 1.0 - frac[..., 2])
                )
                out = out + torch.where(inb, wgt, torch.zeros_like(wgt)) * sample
    return out


def velocity_at(grid: MacGrid, pos: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Trilinearly interpolated velocity at world positions (..., 3), zero
    outside the face arrays (port of ``grids.velocity_at``: three staggered
    gathers; the JAX package has no kernel here)."""
    out = [
        _gather_trilerp_zero_pad(arr, face_index_coords(pos, cfg, axis))
        for axis, arr in enumerate((grid.u, grid.v, grid.w))
    ]
    return torch.stack(out, dim=-1)


def divergence(grid: MacGrid, cfg: SimConfig) -> torch.Tensor:
    """Per-cell velocity divergence, (nx, ny, nz)."""
    du = grid.u[1:, :, :] - grid.u[:-1, :, :]
    dv = grid.v[:, 1:, :] - grid.v[:, :-1, :]
    dw = grid.w[:, :, 1:] - grid.w[:, :, :-1]
    return (du + dv + dw) / cfg.cell_size


def cell_index_of(pos: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """World position -> clamped integer cell index (..., 3) int32."""
    g = (pos - _offset(cfg, pos)) / cfg.cell_size
    idx = torch.floor(g).to(torch.int32)
    hi = torch.tensor(cfg.grid_size, dtype=torch.int32, device=pos.device) - 1
    return torch.minimum(torch.clamp(idx, min=0), hi)


def flat_cell_index(idx3: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """(..., 3) int cell index -> flat index in C order (z fastest)."""
    _, ny, nz = cfg.grid_size
    return (idx3[..., 0] * ny + idx3[..., 1]) * nz + idx3[..., 2]


def unflatten_cell_index(raw: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Flat C-order cell index -> (..., 3) cell index; the inverse of
    :func:`flat_cell_index`."""
    _, ny, nz = cfg.grid_size
    z = raw % nz
    y = (raw // nz) % ny
    x = raw // (ny * nz)
    return torch.stack([x, y, z], dim=-1)


def pad1(x: torch.Tensor, value) -> torch.Tensor:
    """Pad every axis of a 3D tensor by one layer of `value` (out-of-bounds
    cells as SOLID, zero pressure, ...)."""
    out = torch.full([s + 2 for s in x.shape], value, dtype=x.dtype, device=x.device)
    out[1:-1, 1:-1, 1:-1] = x
    return out


def remove_boundary_normal_velocities(grid: MacGrid) -> MacGrid:
    """Zero the normal velocity on all six domain wall face layers."""
    u, v, w = grid.u.clone(), grid.v.clone(), grid.w.clone()
    u[0] = 0.0
    u[-1] = 0.0
    v[:, 0] = 0.0
    v[:, -1] = 0.0
    w[:, :, 0] = 0.0
    w[:, :, -1] = 0.0
    return grid._replace(u=u, v=v, w=w)


def mark_cells(grid: MacGrid, occupancy: torch.Tensor) -> MacGrid:
    """Non-solid cells become FLUID where `occupancy` > 0, else AIR."""
    solid = grid.cell_type == CellType.SOLID
    fluid = (occupancy > 0) & ~solid
    ct = torch.full_like(grid.cell_type, CellType.AIR)
    ct[fluid] = CellType.FLUID
    ct[solid] = CellType.SOLID
    return grid._replace(cell_type=ct)
