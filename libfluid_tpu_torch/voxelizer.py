"""Mesh voxelization: triangle mesh -> solid-cell masks on the simulation
grid (port of ``libfluid_tpu.voxelizer``).

- The voxel grid is aligned to the simulation grid and covers the mesh's
  bounding box padded by one cell on every side, so the corner cell is
  always outside the mesh.
- *Surface* cells are those whose cell-sized box overlaps a triangle (the
  Akenine-Moller separating-axis test), tested over every (triangle,
  candidate cell) pair of a static candidate block per triangle, in chunks
  of triangles, and scattered into the mask.
- *Exterior* cells are found by a 6-connected flood fill from the corner: a
  loop of 6-neighbour dilations masked by ~surface, whose exit flag (a
  sweep that changed nothing) is read from the device every
  ``_CHECK_EVERY`` sweeps; sweeps past the fixpoint change nothing.
  Everything else that is not surface is *interior*, which an obstacle
  contributes to the simulation's solid mask.

Planning (the bounding box, the candidate block) runs on the host in
float64 numpy, as in the JAX package; the masks are tensors on `device`
(None: the CUDA card; ``"cpu"`` on request).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from libfluid_tpu_torch.config import SimConfig, resolve_device
from libfluid_tpu_torch.math import intersection as isect
from libfluid_tpu_torch.renderer import loops

_DILATIONS_PER_SWEEP = 8
_CHECK_EVERY = 4  # sweeps between two reads of the flood fill's exit flag
_PAIRS_PER_CHUNK = 1 << 21  # (triangle, candidate cell) pairs a SAT chunk


class VoxelGrid(NamedTuple):
    """A voxelization result on a local grid aligned to a reference grid."""

    surface: torch.Tensor  # (nx, ny, nz) bool
    exterior: torch.Tensor  # (nx, ny, nz) bool
    interior: torch.Tensor  # (nx, ny, nz) bool
    offset: Tuple[int, int, int]  # local cell (0,0,0) in reference-grid cells
    cell_size: float


def _triangles(positions, indices) -> np.ndarray:
    pos = np.asarray(torch.as_tensor(positions).detach().cpu(), np.float64)
    idx = np.asarray(torch.as_tensor(indices).detach().cpu(), np.int64).reshape(-1, 3)
    return pos[idx]  # (T, 3, 3)


def _surface_mask(tri: torch.Tensor, base: torch.Tensor, grid_size, block) -> torch.Tensor:
    """Scatter the SAT test over every (triangle, candidate cell) pair:
    `tri` (T, 3, 3) cell-space vertices, `base` (T, 3) int64 block origins.
    Cell c has centre c + 0.5 and half-extent 0.5 in cell space."""
    dev = tri.device
    kx, ky, kz = block
    offs = torch.stack(torch.meshgrid(torch.arange(kx, device=dev), torch.arange(ky, device=dev),
                                      torch.arange(kz, device=dev), indexing="ij"), dim=-1).reshape(-1, 3)
    half = torch.full((3,), 0.5, dtype=tri.dtype, device=dev)
    dims = torch.tensor(grid_size, device=dev)
    occ = torch.zeros(int(np.prod(grid_size)), dtype=torch.bool, device=dev)
    step = max(1, _PAIRS_PER_CHUNK // offs.shape[0])
    for a in range(0, tri.shape[0], step):
        t, b = tri[a:a + step, None], base[a:a + step]
        cells = b[:, None, :] + offs[None]  # (C, K, 3)
        hit = isect.aabb_triangle(cells.to(tri.dtype) + 0.5, half, t[..., 0, :], t[..., 1, :], t[..., 2, :])
        keep = hit & torch.all((cells >= 0) & (cells < dims), dim=-1)
        c = cells[keep]
        occ[(c[:, 0] * grid_size[1] + c[:, 1]) * grid_size[2] + c[:, 2]] = True
    return occ.reshape(grid_size)


def _dilate(e: torch.Tensor, surface: torch.Tensor) -> torch.Tensor:
    grown = e.clone()
    grown[1:] |= e[:-1]
    grown[:-1] |= e[1:]
    grown[:, 1:] |= e[:, :-1]
    grown[:, :-1] |= e[:, 1:]
    grown[:, :, 1:] |= e[:, :, :-1]
    grown[:, :, :-1] |= e[:, :, 1:]
    return grown & ~surface


def mark_exterior(surface: torch.Tensor) -> torch.Tensor:
    """6-connected flood fill from the (0, 0, 0) corner through ~surface
    cells, as a fixpoint of dilations."""
    ext = torch.zeros_like(surface)
    ext[0, 0, 0] = ~surface[0, 0, 0]
    sweep = 0
    while True:
        sweep += 1
        new = ext
        for _ in range(_DILATIONS_PER_SWEEP):
            new = _dilate(new, surface)
        changed = torch.any(new != ext)
        ext = new
        if sweep % _CHECK_EVERY == 0 and not loops.flag(changed, "voxelizer.sweep"):
            return ext


def voxelize(positions, indices, cell_size: float, ref_offset=(0.0, 0.0, 0.0), device=None) -> VoxelGrid:
    """Voxelize a mesh on a grid aligned to (ref_offset, cell_size): the
    local grid spans the mesh's bounding box in reference-grid cells,
    padded by one cell."""
    device = resolve_device(device)
    tri = _triangles(positions, indices)
    if tri.shape[0] == 0:
        raise ValueError("cannot voxelize an empty mesh")
    ref_offset = np.asarray(ref_offset, np.float64)
    tri_c = (tri - ref_offset) / float(cell_size)  # cell-space vertices

    lo = np.floor(tri_c.min(axis=(0, 1))).astype(np.int64) - 1
    hi = np.ceil(tri_c.max(axis=(0, 1))).astype(np.int64) + 1
    grid_size = tuple(int(x) for x in (hi - lo))

    # static candidate block: per-triangle cell extent, maxed over the mesh
    t_lo = np.floor(tri_c.min(axis=1)).astype(np.int64)
    t_hi = np.floor(tri_c.max(axis=1)).astype(np.int64)
    block = tuple(int(x) for x in (t_hi - t_lo).max(axis=0) + 1)

    tri_local = torch.as_tensor(tri_c - lo, dtype=torch.float32).to(device)
    base = torch.as_tensor(t_lo - lo).to(device)
    surface = _surface_mask(tri_local, base, grid_size, block)
    exterior = mark_exterior(surface)
    return VoxelGrid(surface=surface, exterior=exterior, interior=~surface & ~exterior,
                     offset=tuple(int(x) for x in lo), cell_size=float(cell_size))


def embed(mask: torch.Tensor, offset, grid_size) -> torch.Tensor:
    """Place a local-grid mask into the reference grid (on the mask's
    device), cropping out-of-range cells."""
    out = torch.zeros(tuple(grid_size), dtype=torch.bool, device=mask.device)
    src_lo = [max(0, -offset[a]) for a in range(3)]
    src_hi = [min(mask.shape[a], grid_size[a] - offset[a]) for a in range(3)]
    if any(src_lo[a] >= src_hi[a] for a in range(3)):
        return out
    dst_lo = [src_lo[a] + offset[a] for a in range(3)]
    dst_hi = [src_hi[a] + offset[a] for a in range(3)]
    out[dst_lo[0]:dst_hi[0], dst_lo[1]:dst_hi[1], dst_lo[2]:dst_hi[2]] = mask[
        src_lo[0]:src_hi[0], src_lo[1]:src_hi[1], src_lo[2]:src_hi[2]]
    return out


def obstacle_cells(positions, indices, cfg: SimConfig, device=None) -> torch.Tensor:
    """Solid-cell mask of a mesh obstacle on the simulation grid (its
    interior cells), on `device`. Compose with
    :func:`libfluid_tpu_torch.sim.state.set_solid`; union obstacles with
    ``|``."""
    vox = voxelize(positions, indices, cfg.cell_size, cfg.grid_offset, device)
    return embed(vox.interior, vox.offset, cfg.grid_size)
