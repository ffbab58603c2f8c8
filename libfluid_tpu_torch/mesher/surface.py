"""Implicit surface sampling from particles, Zhu-Bridson style (port of
``libfluid_tpu.mesher.surface``).

For every node of the sampling grid, the particles within ``extent`` are
averaged with the kernel w = max(0, 1 - d^2/extent^2)^3; the signed value is
|x_avg - x_node| - r, or +1 where no particle is near (outside).

On CUDA tensors the node pass is kernel F (``csrc/surface.cu``): a gather
per node over the particles binned by mesher cell in CSR form
(:func:`bin_particles`), one block per 8 x 8 x 8 tile of nodes with the
particles and bin starts of the tile's support box in shared memory, a
chunk at a time; a tile with no particle in reach writes +1 and returns.
No cap on the particles a cell holds; a support of up to
``MAX_SUPPORT_CELLS`` cells. On CPU tensors it is
:func:`_sample_surface_torch`, the port of the JAX package's scatter
oracle. The gradient with respect to the positions is the autograd
of that oracle, recomputed in backward on either device (port of
``surface._surface_bwd``; a backward kernel is not written yet).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from libfluid_tpu_torch.config import MesherConfig
from libfluid_tpu_torch.sim import kernels


# kernel F keeps the bin starts of a tile's support box in shared memory
MAX_SUPPORT_CELLS = 12


def _support_cells(cfg: MesherConfig) -> int:
    """cr: how many mesher cells the kernel support spans from a particle."""
    return max(math.ceil(cfg.particle_extent / cfg.cell_size), 1)


def sample_surface(
    position: torch.Tensor,
    active: torch.Tensor,
    cfg: MesherConfig,
    particle_radius: Optional[float] = None,
) -> torch.Tensor:
    """Sampled signed surface function on the (nx+1, ny+1, nz+1) node grid:
    kernel F on CUDA tensors, :func:`_sample_surface_torch` on CPU tensors."""
    r = cfg.particle_radius if particle_radius is None else particle_radius
    return _SampleSurface.apply(position, active, cfg, float(r))


class _SampleSurface(torch.autograd.Function):
    @staticmethod
    def forward(ctx, position, active, cfg, radius):
        ctx.args = (cfg, radius)
        ctx.save_for_backward(position, active)
        if not kernels.use_kernel(position, active):
            return _sample_surface_torch(position, active, cfg, radius)
        return _sample_surface_cuda(position, active, cfg, radius)

    @staticmethod
    def backward(ctx, g):
        cfg, radius = ctx.args
        position, active = ctx.saved_tensors
        with torch.enable_grad():
            p = position.detach().requires_grad_()
            (dp,) = torch.autograd.grad(_sample_surface_torch(p, active, cfg, radius), p, g)
        return dp, None, None, None


def _sample_surface_torch(
    position: torch.Tensor,
    active: torch.Tensor,
    cfg: MesherConfig,
    particle_radius: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of kernel F (port of ``surface._sample_surface_jnp``):
    each particle scatters (w, w*x) to the (2 cr)^3 nodes around its cell."""
    r = cfg.particle_radius if particle_radius is None else particle_radius
    nx, ny, nz = cfg.grid_size
    nodes = (nx + 1, ny + 1, nz + 1)
    dev = position.device
    dtype = position.dtype
    dims = torch.tensor(nodes, dtype=torch.int32, device=dev)
    h = cfg.cell_size
    off = torch.tensor(cfg.grid_offset, dtype=dtype, device=dev)
    ext2 = cfg.particle_extent * cfg.particle_extent
    cr = _support_cells(cfg)

    g = (position - off) / h
    base = torch.floor(g).to(torch.int32)

    n_flat = nodes[0] * nodes[1] * nodes[2]
    w_acc = torch.zeros((n_flat,), dtype=dtype, device=dev)
    wp_acc = torch.zeros((n_flat, 3), dtype=dtype, device=dev)
    span = range(-cr + 1, cr + 1)
    offsets = torch.tensor(
        [(dx, dy, dz) for dx in span for dy in span for dz in span], dtype=torch.int32, device=dev
    )

    for d in offsets:
        idx = base + d
        inb = torch.all((idx >= 0) & (idx < dims), dim=-1) & active
        node_pos = off + idx.to(dtype) * h
        d2 = torch.sum((position - node_pos) ** 2, dim=-1) / ext2
        kl = 1.0 - d2
        w = torch.where((kl > 0.0) & inb, kl * kl * kl, torch.zeros_like(kl))
        flat = (idx[..., 0] * nodes[1] + idx[..., 1]) * nodes[2] + idx[..., 2]
        flat = torch.clamp(flat, 0, n_flat - 1).long()
        w_acc.index_add_(0, flat, w)
        wp_acc.index_add_(0, flat, w[:, None] * position)

    w_acc = w_acc.reshape(nodes)
    wp_acc = wp_acc.reshape(nodes + (3,))
    avg_pos = wp_acc / torch.clamp(w_acc, min=1e-30)[..., None]
    axes = [off[a] + torch.arange(nodes[a], dtype=dtype, device=dev) * h for a in range(3)]
    node = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    diff = avg_pos - node
    value = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-30) - r
    return torch.where(w_acc > 0.0, value, torch.ones_like(value))


def bin_particles(position: torch.Tensor, active: torch.Tensor, cfg: MesherConfig):
    """CSR bins of the active particles by mesher cell, over the cell grid
    padded by cr cells on every side (the cells whose particles reach a
    node). Returns (positions sorted by bin (N, 3), bin starts (B + 1,)
    int32); particles outside the padded grid sort past ``starts[B]``."""
    nx, ny, nz = cfg.grid_size
    cr = _support_cells(cfg)
    dev = position.device
    pdims = torch.tensor([nx + 2 * cr, ny + 2 * cr, nz + 2 * cr], dtype=torch.int32, device=dev)
    n_bins = (nx + 2 * cr) * (ny + 2 * cr) * (nz + 2 * cr)

    off = torch.tensor(cfg.grid_offset, dtype=position.dtype, device=dev)
    pb = torch.floor((position - off) / cfg.cell_size).to(torch.int32) + cr
    ok = active & torch.all((pb >= 0) & (pb < pdims), dim=-1)
    bins = (pb[:, 0] * pdims[1] + pb[:, 1]) * pdims[2] + pb[:, 2]
    bins = torch.where(ok, bins, torch.full_like(bins, n_bins))

    order = torch.sort(bins, stable=True).indices
    # a bin's start is the count of the bins before it, in int32 throughout
    counts = torch.zeros((n_bins + 2,), dtype=torch.int32, device=dev)
    counts.index_add_(0, bins + 1, torch.ones_like(bins))
    starts = torch.cumsum(counts[: n_bins + 1], dim=0, dtype=torch.int32)
    return position[order].contiguous(), starts


def _sample_surface_cuda(
    position: torch.Tensor, active: torch.Tensor, cfg: MesherConfig, radius: float
) -> torch.Tensor:
    """Kernel F on CUDA tensors. Replaces
    ``libfluid_tpu/mesher/surface.py:_sample_surface_pallas`` (with its
    8-slot mesher grid ``_build_mesh_slots``): no per-cell cap. Raises for
    a support of more than ``MAX_SUPPORT_CELLS`` cells, never falls back."""
    nx, ny, nz = cfg.grid_size
    cr = _support_cells(cfg)
    if cr > MAX_SUPPORT_CELLS:
        raise ValueError(
            f"surface kernel takes a support of up to {MAX_SUPPORT_CELLS} cells, got {cr} "
            f"(particle_extent {cfg.particle_extent} / cell_size {cfg.cell_size})"
        )
    pos_s, starts = bin_particles(position, active, cfg)
    kernels.check(pos_s, torch.float32, (position.shape[0], 3), "sorted positions")
    out = torch.empty((nx + 1, ny + 1, nz + 1), dtype=torch.float32, device=position.device)
    ox, oy, oz = (float(o) for o in cfg.grid_offset)
    kernels.launch(
        "surface", "lf_surface", pos_s, starts, out, nx, ny, nz, cr,
        float(cfg.cell_size), ox, oy, oz, float(cfg.particle_extent) ** 2, radius,
    )
    return out
