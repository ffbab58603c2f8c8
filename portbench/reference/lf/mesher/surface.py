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
No cap on the particles a cell holds, nor on the support (beyond 12 cells
the box is taken a run of rows at a time). On CPU tensors it is
:func:`_sample_surface_torch`, the port of the JAX package's scatter
oracle.

The gradient with respect to the positions (``surface._surface_bwd`` in the
JAX package, ``jax.vjp`` of the oracle) is kernel F' on CUDA tensors, one
launch over the forward's bins (:func:`sample_surface_bwd`). A forward whose
positions want a gradient launches F in a form that also keeps each node's
sums (W, X), 16 bytes a node (``surface_keep``); F' (``surface_bwd``,
``csrc/surface_bwd.cu``: a block per 8 x 8 x 8 tile of bins, a thread a
particle) forms each node's cotangent words from them as it stages the
nodes in its reach in shared memory, all at once or a slab of x-planes at a
time, and gathers them. No atomics. A forward without a gradient (no_grad,
or positions that do not require one) keeps nothing. On CPU tensors the
gradient is the autograd of the plain version, recomputed in backward;
:func:`_sample_surface_vjp_torch` is its closed form, the plain version of
kernel F'.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from portbench.reference.lf.config import MesherConfig


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
    # (inside forward the grad mode is off, and needs_input_grad does not say
    # whether a graph is recorded)
    return _sample_surface_torch(position, active, cfg, float(r))


def _node_offsets(cr: int, device) -> torch.Tensor:
    """The (2 cr)^3 node offsets from a particle's cell, x slowest."""
    span = range(-cr + 1, cr + 1)
    return torch.tensor(
        [(dx, dy, dz) for dx in span for dy in span for dz in span], dtype=torch.int32, device=device
    )


def _node_sums(position: torch.Tensor, active: torch.Tensor, cfg: MesherConfig):
    """(W (nodes), X (nodes, 3)): each particle scatters (w, w*x) to the
    (2 cr)^3 nodes around its cell."""
    nx, ny, nz = cfg.grid_size
    nodes = (nx + 1, ny + 1, nz + 1)
    dev = position.device
    dtype = position.dtype
    dims = torch.tensor(nodes, dtype=torch.int32, device=dev)
    h = cfg.cell_size
    off = torch.tensor(cfg.grid_offset, dtype=dtype, device=dev)
    ext2 = cfg.particle_extent * cfg.particle_extent

    g = (position - off) / h
    base = torch.floor(g).to(torch.int32)

    n_flat = nodes[0] * nodes[1] * nodes[2]
    w_acc = torch.zeros((n_flat,), dtype=dtype, device=dev)
    wp_acc = torch.zeros((n_flat, 3), dtype=dtype, device=dev)

    for d in _node_offsets(_support_cells(cfg), dev):
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
    return w_acc.reshape(nodes), wp_acc.reshape(nodes + (3,))


def _node_positions(cfg: MesherConfig, dtype, device) -> torch.Tensor:
    """(nodes, 3) world positions of the sampling grid's nodes."""
    off = torch.tensor(cfg.grid_offset, dtype=dtype, device=device)
    axes = [off[a] + torch.arange(cfg.grid_size[a] + 1, dtype=dtype, device=device) * cfg.cell_size
            for a in range(3)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def _sample_surface_torch(
    position: torch.Tensor,
    active: torch.Tensor,
    cfg: MesherConfig,
    particle_radius: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of kernel F (port of ``surface._sample_surface_jnp``):
    each particle scatters (w, w*x) to the (2 cr)^3 nodes around its cell."""
    r = cfg.particle_radius if particle_radius is None else particle_radius
    return _node_values(*_node_sums(position, active, cfg), cfg, r)


def _node_values(w_acc: torch.Tensor, wp_acc: torch.Tensor, cfg: MesherConfig, r: float) -> torch.Tensor:
    """|X / W - x_n| - r of each node, +1 where W = 0."""
    avg_pos = wp_acc / torch.clamp(w_acc, min=1e-30)[..., None]
    diff = avg_pos - _node_positions(cfg, w_acc.dtype, w_acc.device)
    value = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-30) - r
    return torch.where(w_acc > 0.0, value, torch.ones_like(value))


def bin_particles(position: torch.Tensor, active: torch.Tensor, cfg: MesherConfig):
    """CSR bins of the active particles by mesher cell, over the cell grid
    padded by cr cells on every side (the cells whose particles reach a
    node). Returns (positions sorted by bin (N, 3), bin starts (B + 1,)
    int32, the sort's order (N,): sorted row i is particle ``order[i]``);
    particles outside the padded grid sort past ``starts[B]``."""
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
    return position[order].contiguous(), starts, order


