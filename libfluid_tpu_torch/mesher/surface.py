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

from libfluid_tpu_torch.config import MesherConfig
from libfluid_tpu_torch.sim import kernels


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
    return _SampleSurface.apply(position, active, cfg, float(r), torch.is_grad_enabled())


class _SampleSurface(torch.autograd.Function):
    @staticmethod
    def forward(ctx, position, active, cfg, radius, grad_enabled):
        ctx.args = (cfg, radius)
        ctx.save_for_backward(position, active)
        if not kernels.use_kernel(position, active):
            return _sample_surface_torch(position, active, cfg, radius)
        binned = _binned(position, active, cfg)
        if not (grad_enabled and ctx.needs_input_grad[0]):
            return _sample_surface_cuda(binned, cfg, radius)
        out, sums = _sample_surface_keep_cuda(binned, cfg, radius)
        ctx.kept = (binned, sums)  # kernel F' reads the same bins and the node sums
        return out

    @staticmethod
    def backward(ctx, g):
        cfg, radius = ctx.args
        position, active = ctx.saved_tensors
        if kernels.use_kernel(position, active, g):
            return sample_surface_bwd(*ctx.kept, g, cfg), None, None, None, None
        with torch.enable_grad():
            p = position.detach().requires_grad_()
            (dp,) = torch.autograd.grad(_sample_surface_torch(p, active, cfg, radius), p, g)
        return dp, None, None, None, None


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


def _sample_surface_keep_torch(
    position: torch.Tensor,
    active: torch.Tensor,
    cfg: MesherConfig,
    particle_radius: Optional[float] = None,
):
    """Plain version of ``surface_keep``: the node values of
    :func:`_sample_surface_torch` and the node sums (W, X) of
    :func:`_node_sums` they come from, as (nx+1, ny+1, nz+1, 4)."""
    r = cfg.particle_radius if particle_radius is None else particle_radius
    w_acc, wp_acc = _node_sums(position, active, cfg)
    return _node_values(w_acc, wp_acc, cfg, r), torch.cat([w_acc[..., None], wp_acc], dim=-1)


def _node_words_torch(sums: torch.Tensor, g: torch.Tensor, cfg: MesherConfig) -> torch.Tensor:
    """The node words of kernel F' from the node sums ``sums`` (W, X) of
    :func:`_sample_surface_keep_torch`: (nx+1, ny+1, nz+1, 4) words
    (a_n, b_n) for the cotangent ``g`` of the node values. Per node with
    W > 0 (else zeros), diff = X / W - x_n and

        a_n = g_n diff / (sqrt(|diff|^2 + 1e-30) max(W, 1e-30)),  b_n = a_n . diff:

    the cotangents of the node sums are d X_n = a_n and
    d W_n = -a_n . avg_n = -(a_n . x_n + b_n)."""
    w_acc, wp_acc = sums[..., 0], sums[..., 1:]
    w_safe = torch.clamp(w_acc, min=1e-30)
    diff = wp_acc / w_safe[..., None] - _node_positions(cfg, sums.dtype, sums.device)
    scale = g / (torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-30) * w_safe)
    a = torch.where((w_acc > 0.0)[..., None], scale[..., None] * diff, torch.zeros_like(diff))
    # (a positive float32 W is a sum of cubes of at least 2^-24: the clamp at
    # 1e-30 never holds its cotangent back)
    return torch.cat([a, torch.sum(a * diff, dim=-1, keepdim=True)], dim=-1)


def _node_cotangents_torch(
    position: torch.Tensor, active: torch.Tensor, g: torch.Tensor, cfg: MesherConfig
) -> torch.Tensor:
    """The node words (a_n, b_n) of kernel F' for the cotangent ``g`` of the
    node values, from the particles: :func:`_node_words_torch` of the node
    sums."""
    w_acc, wp_acc = _node_sums(position, active, cfg)
    return _node_words_torch(torch.cat([w_acc[..., None], wp_acc], dim=-1), g, cfg)


def _gather_cotangents_torch(
    position: torch.Tensor, active: torch.Tensor, ab: torch.Tensor, cfg: MesherConfig
) -> torch.Tensor:
    """Plain version of the gather of kernel F' (``surface_bwd``): per
    particle over the (2 cr)^3 nodes around its cell that lie in the grid,
    with d = x_p - x_n, kl = 1 - |d|^2 / ext^2 and w = kl^3 where kl > 0,

        d x_p = sum_n (a_n . d - b_n) 3 kl^2 (-2 d / ext^2) + a_n w.

    a . x_p - a . avg is formed from d and b, both of the support's size, not
    from world coordinates. Inactive particles get 0."""
    nx, ny, nz = cfg.grid_size
    nodes = (nx + 1, ny + 1, nz + 1)
    dev, dtype = position.device, position.dtype
    dims = torch.tensor(nodes, dtype=torch.int32, device=dev)
    h = cfg.cell_size
    off = torch.tensor(cfg.grid_offset, dtype=dtype, device=dev)
    ext2 = cfg.particle_extent * cfg.particle_extent
    ab = ab.reshape(-1, 4)

    base = torch.floor((position - off) / h).to(torch.int32)
    n_flat = nodes[0] * nodes[1] * nodes[2]
    out = torch.zeros_like(position)
    for d in _node_offsets(_support_cells(cfg), dev):
        idx = base + d
        inb = torch.all((idx >= 0) & (idx < dims), dim=-1) & active
        dist = position - (off + idx.to(dtype) * h)
        kl = 1.0 - torch.sum(dist**2, dim=-1) / ext2
        live = (kl > 0.0) & inb
        flat = (idx[..., 0] * nodes[1] + idx[..., 1]) * nodes[2] + idx[..., 2]
        word = ab[torch.clamp(flat, 0, n_flat - 1).long()]
        an = word[:, :3]
        slope = (torch.sum(an * dist, dim=-1) - word[:, 3]) * (3.0 * kl * kl) * (-2.0 / ext2)
        term = slope[:, None] * dist + an * (kl * kl * kl)[:, None]
        out += torch.where(live[:, None], term, torch.zeros_like(term))
    return out


def _sample_surface_vjp_torch(
    position: torch.Tensor,
    active: torch.Tensor,
    g: torch.Tensor,
    cfg: MesherConfig,
    particle_radius: Optional[float] = None,
) -> torch.Tensor:
    """Cotangent (N, 3) of the positions for the cotangent ``g`` of the node
    values, in closed form: the plain version of kernel F' (the node words,
    then the gather), equal to ``jax.vjp`` of
    ``surface._sample_surface_jnp``. The radius shifts the values only and
    has no part in it."""
    ab = _node_cotangents_torch(position, active, g, cfg)
    return _gather_cotangents_torch(position, active, ab, cfg)


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


def _binned(position: torch.Tensor, active: torch.Tensor, cfg: MesherConfig):
    """:func:`bin_particles` for the kernels: raises for positions the
    kernels do not take."""
    binned = bin_particles(position, active, cfg)
    kernels.check(binned[0], torch.float32, (position.shape[0], 3), "sorted positions")
    return binned


def _sample_surface_cuda(binned, cfg: MesherConfig, radius: float) -> torch.Tensor:
    """Kernel F on the bins of :func:`_binned` (CUDA tensors). Replaces
    ``libfluid_tpu/mesher/surface.py:_sample_surface_pallas`` (with its
    8-slot mesher grid ``_build_mesh_slots``): no per-cell cap. Never falls
    back."""
    nx, ny, nz = cfg.grid_size
    pos_s, starts, _ = binned
    out = torch.empty((nx + 1, ny + 1, nz + 1), dtype=torch.float32, device=pos_s.device)
    kernels.launch("surface", "lf_surface", pos_s, starts, out, *_geometry(cfg), radius)
    return out


def _sample_surface_keep_cuda(binned, cfg: MesherConfig, radius: float):
    """Kernel F on the bins of :func:`_binned` (CUDA tensors) in the form
    that also writes each node's sums (``surface_keep``): the node values and
    the (nx+1, ny+1, nz+1, 4) sums (W, X) of
    :func:`_sample_surface_keep_torch`, zeros where no particle is in reach.
    Never falls back."""
    nx, ny, nz = cfg.grid_size
    pos_s, starts, _ = binned
    out = torch.empty((nx + 1, ny + 1, nz + 1), dtype=torch.float32, device=pos_s.device)
    sums = torch.empty((nx + 1, ny + 1, nz + 1, 4), dtype=torch.float32, device=pos_s.device)
    kernels.launch("surface_keep", "lf_surface_keep", pos_s, starts, out, sums, *_geometry(cfg), radius)
    return out, sums


def _geometry(cfg: MesherConfig):
    """The grid arguments the surface kernels share."""
    ox, oy, oz = (float(o) for o in cfg.grid_offset)
    return (*cfg.grid_size, _support_cells(cfg), float(cfg.cell_size), ox, oy, oz,
            float(cfg.particle_extent) ** 2)


def surface_bwd_gather(binned, sums: torch.Tensor, g: torch.Tensor, cfg: MesherConfig) -> torch.Tensor:
    """Kernel F' on the bins of :func:`_binned` and the node sums of
    :func:`_sample_surface_keep_cuda` (CUDA tensors): a thread a binned
    particle gathers the node words (:func:`_node_words_torch`) of the nodes
    in its reach (:func:`_gather_cotangents_torch`), formed from the sums and
    the cotangent ``g`` (nx+1, ny+1, nz+1) as a tile's nodes are staged.
    Returns (N, 3) in the sorted order; unbinned particles get 0."""
    nx, ny, nz = cfg.grid_size
    nodes = (nx + 1, ny + 1, nz + 1)
    pos_s, starts, _ = binned
    if not kernels.use_kernel(pos_s, starts, sums, g):
        raise ValueError(f"surface_bwd_gather takes CUDA tensors, got {pos_s.device}")
    g = g.contiguous()
    kernels.check(sums, torch.float32, (*nodes, 4), "node sums")
    kernels.check(g, torch.float32, nodes, "node cotangent")
    d_sorted = torch.zeros_like(pos_s)
    kernels.launch("surface_bwd", "lf_surface_bwd", pos_s, starts, sums, g, d_sorted, *_geometry(cfg))
    return d_sorted


def sample_surface_bwd(binned, sums: torch.Tensor, g: torch.Tensor, cfg: MesherConfig) -> torch.Tensor:
    """Kernel F' on the bins of :func:`_binned` and the node sums the forward
    kept (CUDA tensors): the cotangent (N, 3) of the positions from the
    cotangent ``g`` (nx+1, ny+1, nz+1) of the node values. Stands in for
    ``libfluid_tpu/mesher/surface.py:_surface_bwd``. One launch,
    :func:`surface_bwd_gather`; the result goes back through the sort's
    order. No atomics: the same bits from run to run."""
    d_sorted = surface_bwd_gather(binned, sums, g, cfg)
    out = torch.empty_like(d_sorted)
    out[binned[2]] = d_sorted
    return out
