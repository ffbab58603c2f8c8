"""Fused particle sort + slot-grid build (port of ``libfluid_tpu.sim.slotsort``).

Two sorts put the particle SoA into rank-major slot order: a stable light
sort of the cell ids gives each particle its rank in its cell, and a second
sort by the rank-major slot id ``rank * C + cell`` (overflow and inactive rows
parked past ``K*C`` in light-sorted order) moves the payload. The sorted
payload is then the slot grid with the empty slots squeezed out, and the
slot grid is its expansion: slot ``j = rank*C + cell`` reads sorted row
``ins[j]`` (the exclusive cumsum of the kept mask) when the cell holds more
than ``rank`` particles, else 0. That gather is kernel A.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libfluid_tpu_torch import grids
from libfluid_tpu_torch.config import SimConfig, TransferScheme
from libfluid_tpu_torch.sim import kernels
from libfluid_tpu_torch.sim.binning import Binning
from libfluid_tpu_torch.sim.slots import SlotGrid, WIDTH


class RankSorted(NamedTuple):
    """Particle SoA in rank-major slot order plus what the expansion needs."""

    state: object            # SimState, particle arrays permuted
    counts: torch.Tensor     # (C,) int32 particles per cell (uncapped)
    ins: torch.Tensor        # (K*C,) int32 sorted-payload row of each (rank, cell)
    key_sorted: torch.Tensor  # (N,) int32 rank-major slot id; >= K*C parked
    n_kept: torch.Tensor     # int32 scalar
    n_overflow: torch.Tensor  # int32 scalar; overflow rows are [n_kept, n_kept + n_overflow)
    payT: torch.Tensor       # (16, N) transposed sorted payload (pos, 1, vel, affine)


class SortBuildResult(NamedTuple):
    state: object            # SimState with particle arrays in slot order
    bins: Binning
    slot_grid: SlotGrid
    n_kept: torch.Tensor     # rows with a slot (int32 scalar)
    n_overflow: torch.Tensor  # active rows past slot capacity


def sort_rank_major(state, cfg: SimConfig) -> RankSorted:
    """Sort the particle SoA into rank-major slot order without building the
    slot grid."""
    n = state.position.shape[0]
    num_cells = cfg.num_cells
    k = cfg.max_neighbors_per_cell
    kc = num_cells * k
    dev = state.position.device
    iota = torch.arange(n, dtype=torch.int32, device=dev)

    cell = grids.flat_cell_index(grids.cell_index_of(state.position, cfg), cfg)
    cell = torch.where(state.active, cell, torch.full_like(cell, num_cells))

    # --- light sort: ranks + counts without moving the payload ---
    cell_s, order = torch.sort(cell, stable=True)
    starts = torch.where(cell_s != torch.roll(cell_s, 1), iota, torch.zeros_like(iota))
    starts[0] = 0
    rank_s = iota - torch.cummax(starts, dim=0).values
    counts = torch.bincount(cell_s, minlength=num_cells + 1)[:num_cells].to(torch.int32)

    kept_s = (cell_s < num_cells) & (rank_s < k)
    over_s = (cell_s < num_cells) & (rank_s >= k)
    key_s = torch.where(
        kept_s,
        rank_s * num_cells + cell_s,
        kc + torch.where(over_s, iota, n + iota),
    )
    key = torch.empty_like(key_s)
    key[order] = key_s

    # --- payload sort: the keys are unique, so an argsort is the sort ---
    perm = torch.argsort(key)
    key_sorted = key[perm]
    pos = state.position[perm]
    vel = state.velocity[perm]
    aff = state.affine[perm]

    n_kept = kept_s.sum(dtype=torch.int32)
    n_overflow = over_s.sum(dtype=torch.int32)
    active = iota < (n_kept + n_overflow)

    ranks = torch.arange(k, dtype=torch.int32, device=dev)
    kr = (counts[None, :] > ranks[:, None]).reshape(-1).to(torch.int32)
    ins = torch.cumsum(kr, dim=0, dtype=torch.int32) - kr  # exclusive

    use_affine = cfg.scheme == TransferScheme.APIC
    mask_col = torch.ones((n, 1), dtype=cfg.dtype, device=dev)
    aff_cols = aff.reshape(n, 9) if use_affine else torch.zeros((n, 9), dtype=cfg.dtype, device=dev)
    payT = torch.cat([pos, mask_col, vel, aff_cols], dim=1).t().contiguous()  # (16, N)

    state = state._replace(position=pos, velocity=vel, affine=aff, active=active)
    return RankSorted(
        state=state, counts=counts, ins=ins, key_sorted=key_sorted,
        n_kept=n_kept, n_overflow=n_overflow, payT=payT,
    )


# ---------------------------------------------------------------------------
# Kernel A: slot expand
# ---------------------------------------------------------------------------


def _expand_torch(payT: torch.Tensor, ins: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`expand` (port of ``slotsort._expand_jnp``)."""
    num_c = counts.shape[0]
    k = ins.shape[0] // num_c
    ranks = torch.arange(k, dtype=torch.int32, device=ins.device)
    valid = (counts[None, :] > ranks[:, None]).reshape(-1)
    src = torch.where(valid, ins, torch.zeros_like(ins)).long()
    return torch.where(valid[None, :], payT[:, src], payT.new_zeros(()))


def _expand_cuda(payT: torch.Tensor, ins: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    num_c = counts.shape[0]
    k = ins.shape[0] // num_c
    kernels.check(payT, torch.float32, (WIDTH, payT.shape[1]), "payT")
    kernels.check(ins, torch.int32, (k * num_c,), "ins")
    kernels.check(counts, torch.int32, (num_c,), "counts")
    out = torch.empty((WIDTH, k * num_c), dtype=torch.float32, device=payT.device)
    kernels.launch("expand", "lf_expand", payT, ins, counts, out, payT.shape[1], k, num_c)
    return out


class _Expand(torch.autograd.Function):
    """Kernel A (CUDA) or its plain version (CPU); the backward scatters the
    slot cotangent back to payload row ``ins[j]`` of every valid slot ``j``
    (port of ``slotsort._expand_bwd``, jnp there and plain PyTorch here).
    The valid slots read distinct rows, so the scatter-add is an indexed
    write of the valid slots' columns: at 128^3 an ``index_add_`` over all
    25.2M slots took 246 ms on the card, 90 % of a backward's device time."""

    @staticmethod
    def forward(ctx, payT, ins, counts):
        ctx.save_for_backward(ins, counts)
        ctx.ncols = payT.shape[1]
        if not kernels.use_kernel(payT, ins, counts):
            return _expand_torch(payT, ins, counts)
        return _expand_cuda(payT, ins, counts)

    @staticmethod
    def backward(ctx, g):
        ins, counts = ctx.saved_tensors
        num_c = counts.shape[0]
        k = ins.shape[0] // num_c
        ranks = torch.arange(k, dtype=torch.int32, device=ins.device)
        valid = (counts[None, :] > ranks[:, None]).reshape(-1)
        slots = torch.nonzero(valid).squeeze(1)
        dpay = g.new_zeros((g.shape[0], ctx.ncols))
        dpay[:, ins[slots].long()] = g[:, slots]
        return dpay, None, None


def expand(payT: torch.Tensor, ins: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Slot payload (16, K*num_c): ``out[:, j] = payT[:, ins[j]]`` where cell
    ``j % num_c`` holds more than ``j // num_c`` particles, else 0.

    Replaces ``libfluid_tpu/sim/slotsort.py:_expand_kernel`` (through
    ``_expand_impl``) and its ``custom_vjp``. CUDA: ``csrc/expand.cu``;
    CPU: :func:`_expand_torch`.
    """
    return _Expand.apply(payT, ins, counts)


def expand_range(rs: RankSorted, cfg: SimConfig, c0: int, num_c: int) -> torch.Tensor:
    """Slot payload (16, K, num_c) of the cell range [c0, c0 + num_c)."""
    k = cfg.max_neighbors_per_cell
    ins_s = rs.ins.reshape(k, cfg.num_cells)[:, c0 : c0 + num_c].contiguous()
    cnt_s = rs.counts[c0 : c0 + num_c].contiguous()
    return expand(rs.payT, ins_s.reshape(-1), cnt_s).reshape(WIDTH, k, num_c)


def sort_and_build(state, cfg: SimConfig) -> SortBuildResult:
    """Sort the particle SoA into rank-major slot order and build the slot
    grid. Only ``cell_of``/``cell_count``/``occupancy`` of the returned
    ``bins`` are meaningful (see :class:`Binning`)."""
    num_cells = cfg.num_cells
    k = cfg.max_neighbors_per_cell
    kc = num_cells * k

    rs = sort_rank_major(state, cfg)
    nx, ny, nz = cfg.grid_size
    data = expand_range(rs, cfg, 0, num_cells).reshape(WIDTH, k, nx, ny, nz)

    n = rs.key_sorted.shape[0]
    dev = rs.key_sorted.device
    slot_of = torch.clamp(rs.key_sorted, max=kc)
    overflow = (rs.key_sorted >= kc) & (rs.key_sorted < kc + n)
    counts = rs.counts
    cell_of = grids.flat_cell_index(grids.cell_index_of(rs.state.position, cfg), cfg)
    bins = Binning(
        order=torch.arange(n, dtype=torch.int32, device=dev),
        cell_of=torch.where(rs.state.active, cell_of, torch.full_like(cell_of, num_cells)),
        cell_start=torch.cumsum(counts, dim=0, dtype=torch.int32) - counts,
        cell_count=counts,
        occupancy=counts.reshape(cfg.grid_size),
    )
    slot_grid = SlotGrid(data=data, slot_of=slot_of, overflow=overflow)
    return SortBuildResult(
        state=rs.state, bins=bins, slot_grid=slot_grid,
        n_kept=rs.n_kept, n_overflow=rs.n_overflow,
    )
