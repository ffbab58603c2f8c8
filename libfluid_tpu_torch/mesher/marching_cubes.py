"""Marching cubes into a fixed-capacity triangle soup (port of
``libfluid_tpu.mesher.marching_cubes``).

Cells are processed in z-blocks of the JAX package's size and order
((x, y, dz) row-major within a block): corner values, the case index
(bit i set where corner i is < 0), the crossing point on each of the 12
edges (t = v1 / (v1 - v2)), then the block's triangles are appended to the
buffer after those of the earlier blocks. Triangles past ``max_triangles``
are dropped; ``count`` is capped at the capacity. The JAX package runs this
outside any kernel, and so does the port: plain PyTorch, one host read per
block (the block's triangle count; read site ``marching_cubes.nonzero``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from libfluid_tpu_torch import profiling
from libfluid_tpu_torch.config import MesherConfig
from libfluid_tpu_torch.mesher import tables
from libfluid_tpu_torch.mesher.surface import sample_surface

MAX_TRIS_PER_CELL = 5

# cells per z-block (the JAX package's rule: bounds the block temporaries)
_BLOCK_CELLS = 1 << 20


class MeshBuffers(NamedTuple):
    """Fixed-capacity triangle soup: ``vertices[i]`` is a (3, 3) triangle
    (rows = vertices); entries past ``count`` are zero."""

    vertices: torch.Tensor  # (max_triangles, 3, 3)
    count: torch.Tensor  # () int32

    @property
    def valid(self) -> torch.Tensor:
        return torch.arange(self.vertices.shape[0], device=self.vertices.device) < self.count


def _z_block(cfg: MesherConfig) -> int:
    nx, ny, nz = cfg.grid_size
    zb = max(1, min(nz, _BLOCK_CELLS // (nx * ny)))
    while nz % zb:
        zb -= 1
    return zb


def marching_cubes(sdf: torch.Tensor, cfg: MesherConfig) -> MeshBuffers:
    """Extract the zero level set of `sdf` sampled on (nx+1, ny+1, nz+1) nodes."""
    nx, ny, nz = cfg.grid_size
    h = cfg.cell_size
    dev = sdf.device
    dtype = sdf.dtype
    off = [float(o) for o in cfg.grid_offset]
    tri_table = torch.as_tensor(tables.TRI_TABLE, device=dev)  # (256, 16)
    ntri_table = torch.as_tensor(tables.NTRI_TABLE, device=dev)  # (256,)
    ec_a = tables.EDGE_CORNERS[:, 0]
    ec_b = tables.EDGE_CORNERS[:, 1]
    zb = _z_block(cfg)

    # per-edge endpoint cell-relative offsets, (12, 1) each
    co = tables.CORNER_OFFSETS

    def col(values):
        return torch.tensor(values, dtype=dtype, device=dev).reshape(12, 1)

    ax, ay, az = (col([co[c][a] for c in ec_a]) for a in range(3))
    dx = col([co[c][0] for c in ec_b]) - ax
    dy = col([co[c][1] for c in ec_b]) - ay
    dz = col([co[c][2] for c in ec_b]) - az
    ia = torch.as_tensor(ec_a, dtype=torch.long, device=dev)
    ib = torch.as_tensor(ec_b, dtype=torch.long, device=dev)
    bits = (1 << torch.arange(8, dtype=torch.int32, device=dev))[:, None]
    swap = torch.tensor([0, 2, 1], dtype=torch.long, device=dev)

    # block-local cell coordinates, (cb,) each, order (x, y, dz) row-major
    gx, gy, gz = (
        c.reshape(-1).to(dtype)
        for c in torch.meshgrid(
            torch.arange(nx, device=dev), torch.arange(ny, device=dev),
            torch.arange(zb, device=dev), indexing="ij",
        )
    )

    cap = cfg.max_triangles
    buf = torch.zeros((cap, 3, 3), dtype=dtype, device=dev)
    count = 0
    for z0 in range(0, nz, zb):
        # corner values (8, cb), corners in the tables' order
        v = torch.stack([
            sdf[ox : ox + nx, oy : oy + ny, z0 + oz : z0 + oz + zb].reshape(-1)
            for ox, oy, oz in (tuple(int(x) for x in c) for c in co)
        ])
        case = torch.sum((v < 0.0).to(torch.int32) * bits, dim=0)  # (cb,)

        # interpolated point on each of the 12 edges, component-major (12, cb)
        va = v[ia]
        vb = v[ib]
        denom = va - vb
        t = va / torch.where(torch.abs(denom) > 1e-30, denom, torch.ones_like(denom))
        ex = off[0] + h * (gx[None] + ax + dx * t)
        ey = off[1] + h * (gy[None] + ay + dy * t)
        ez = off[2] + h * ((gz + z0)[None] + az + dz * t)

        ntris = ntri_table[case]  # (cb,)
        k5 = torch.arange(MAX_TRIS_PER_CELL, device=dev)
        tvalid = (k5[None, :] < ntris[:, None]).reshape(-1)
        with profiling.blocking("marching_cubes.nonzero"):
            rows_i = torch.nonzero(tvalid).reshape(-1)
        n_valid = rows_i.shape[0]
        keep = max(0, min(n_valid, cap - count))  # the rest is dropped
        if keep > 0:
            rows_i = rows_i[:keep]
            c_i = rows_i // MAX_TRIS_PER_CELL  # source cell
            k_i = rows_i % MAX_TRIS_PER_CELL  # triangle within the cell
            # edge ids with the last two swapped, so normals point along +grad(sdf)
            cols = 3 * k_i[:, None] + swap[None]
            edges = torch.clamp(tri_table[case[c_i][:, None], cols], min=0).long()  # (keep, 3)
            cc = c_i[:, None]
            buf[count : count + keep] = torch.stack([ex[edges, cc], ey[edges, cc], ez[edges, cc]], dim=-1)
        count += n_valid
    return MeshBuffers(
        vertices=buf, count=torch.tensor(min(count, cap), dtype=torch.int32, device=dev)
    )


def generate_mesh(
    position: torch.Tensor,
    active: torch.Tensor,
    cfg: MesherConfig,
    particle_radius: Optional[float] = None,
) -> MeshBuffers:
    """particles -> SDF -> triangles: a ``mesh`` span of
    :mod:`libfluid_tpu_torch.profiling` holding ``surface`` and
    ``marching_cubes``."""
    with profiling.span("mesh"):
        with profiling.span("surface"):
            sdf = sample_surface(position, active, cfg, particle_radius)
        with profiling.span("marching_cubes"):
            return marching_cubes(sdf, cfg)
