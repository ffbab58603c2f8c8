"""Anti-clumping position correction (port of ``libfluid_tpu.sim.correction``).

Every particle accumulates a repulsive spring from the particles of its 3x3x3
cell neighbourhood, ``sum_j w_ij (x_i - x_j)`` with
``w = (1 - d^2/re^2)^3 / d`` and re = h/sqrt(2), and moves by
spring * dt * stiffness * re, clamped back into the domain (no skin).

The first ``kc = min(correction_capacity, K)`` slots of each cell take the
dense pass over the slot grid (kernel E, ``csrc/correction.cu``, on the
card; :func:`_springs_torch` on the CPU), and its gradient kernel E'
(``csrc/correction_bwd.cu``; on the CPU the autograd of the plain version,
whose closed form is :func:`_springs_vjp_torch`). Exactly coincident pairs add a
deterministic hash jitter (:mod:`portbench.reference.lf.sim.jitterhash`) scaled
by the slot's coincident count. Particles past the window (rank >= kc,
slot overflow included) get a compacted per-particle pass against the
resident field, :func:`overflow_springs`, up to
``correction_overflow_capacity`` of them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.lf import grids
from portbench.reference.lf.config import SimConfig
from portbench.reference.lf.sim import jitterhash
from portbench.reference.lf.sim import slots as slots_mod

_ZERO_ORIGIN = (0, 0, 0)


def _pair_weight(sq: torch.Tensor, re2: float) -> torch.Tensor:
    """(1 - sq/re2)^3 / sqrt(sq), zero for degenerate (sq < 1e-12) pairs."""
    kern = torch.clamp(1.0 - sq / re2, min=0.0) ** 3
    w = kern * torch.rsqrt(torch.clamp(sq, min=1e-12))
    return torch.where(sq < 1e-12, torch.zeros_like(w), w)


# the most bytes of one (KC, KC, slab) pair tensor of :func:`_springs_torch`
_PAIR_BYTES = 1 << 31


def _springs_torch(
    res_pos: torch.Tensor, res_mask: torch.Tensor, re2: float, seed: int,
    origin=_ZERO_ORIGIN,
) -> torch.Tensor:
    """Per-slot springs (3, KC, nx, ny, nz), plain version of kernel E (port
    of ``correction._springs_jnp``): for each of the 27 offsets the
    neighbour cell's slots are a shifted copy of the slot grid, and the
    (KC, KC) pairs reduce over the neighbour axis.

    The cells go in x-slabs of as many planes as keep a pair tensor within
    ``_PAIR_BYTES``, each reading its neighbours from the slot grid padded
    by one plane of empty cells on every side. Every element's arithmetic
    and every reduction is that of the whole grid at once, so the result
    does not depend on the slab."""
    kc = res_pos.shape[1]
    nx, ny, nz = res_pos.shape[2:]
    slab = max(1, _PAIR_BYTES // (kc * kc * ny * nz * res_pos.element_size()))
    pad_pos = F.pad(res_pos, (1, 1, 1, 1, 1, 1))
    pad_mask = F.pad(res_mask, (1, 1, 1, 1, 1, 1))
    eye = torch.eye(kc, dtype=res_pos.dtype, device=res_pos.device).reshape(kc, kc, 1, 1, 1)
    springs = torch.empty_like(res_pos)

    for x0 in range(0, nx, slab):
        x1 = min(x0 + slab, nx)
        pos, mask = res_pos[:, :, x0:x1], res_mask[:, x0:x1]
        wsum = torch.zeros_like(mask)
        wnbr = torch.zeros_like(pos)
        coincident = torch.zeros_like(mask)
        for d in slots_mod.NEIGHBOR_OFFSETS:
            ox, oy, oz = d
            cells = (slice(1 + ox + x0, 1 + ox + x1), slice(1 + oy, 1 + oy + ny), slice(1 + oz, 1 + oz + nz))
            nbr_pos = pad_pos[(slice(None), slice(None)) + cells]
            nbr_mask = pad_mask[(slice(None),) + cells]
            # pairwise (KC res, KC nbr, slab, ny, nz)
            sq = sum((pos[i][:, None] - nbr_pos[i][None, :]) ** 2 for i in range(3))
            pair = mask[:, None] * nbr_mask[None, :]
            if d == (0, 0, 0):
                pair = pair * (1.0 - eye)  # a slot is not its own neighbour
            w = _pair_weight(sq, re2) * pair
            wsum += torch.sum(w, dim=1)
            wnbr += torch.stack([torch.sum(w * nbr_pos[i][None, :], dim=1) for i in range(3)])
            coincident += torch.sum(torch.where(sq < 1e-12, pair, torch.zeros_like(pair)), dim=1)
            del sq, pair, w  # before the next offset's: at 256³ each is ~2 GB

        jitter = jitterhash.jitter_field(
            seed, kc, (x1 - x0, ny, nz), (origin[0] + x0, origin[1], origin[2]), res_pos.dtype,
            res_pos.device,
        )
        springs[:, :, x0:x1] = pos * wsum[None] - wnbr + coincident[None] * jitter
    return springs


def _springs(res_pos, res_mask, seed: int, origin, re2: float, cfg: SimConfig) -> torch.Tensor:
    """Kernels E and E' on CUDA tensors, :func:`_springs_torch` and its
    autograd on CPU tensors."""
    return _springs_torch(res_pos, res_mask, re2, seed, origin)


def overflow_springs(
    position: torch.Tensor,
    truncated: torch.Tensor,
    res_pos: torch.Tensor,
    res_mask: torch.Tensor,
    re2: float,
    grid_cfg: SimConfig,
    cap: int,
    trunc_start=None,
):
    """Springs for up to `cap` particles outside the resident slot window
    (`truncated`), each against the resident slots of its 27 neighbour
    cells; coincident pairs add nothing here. With `trunc_start` the rows
    are the contiguous range ``trunc_start ... trunc_start + cap`` of the
    rank-major slot order, else the first `cap` truncated rows. Returns
    (indices (cap,), springs (cap, 3)); an index of n marks an unused row."""
    n = position.shape[0]
    cap = min(cap, n)
    kc = res_mask.shape[0]
    num_cells = grid_cfg.num_cells
    dev = position.device

    if trunc_start is not None:
        idx = trunc_start + torch.arange(cap, dtype=torch.int32, device=dev)
        idx = torch.where(
            truncated[torch.clamp(idx, max=n - 1).long()] & (idx < n),
            idx, torch.full_like(idx, n),
        )
    else:
        found = torch.nonzero(truncated).reshape(-1)[:cap].to(torch.int32)
        idx = torch.full((cap,), n, dtype=torch.int32, device=dev)
        idx[: found.shape[0]] = found
    ok = idx < n
    p = position[torch.clamp(idx, max=n - 1).long()]  # (cap, 3)

    cell3 = grids.cell_index_of(p, grid_cfg)
    offs = torch.tensor(slots_mod.NEIGHBOR_OFFSETS, dtype=torch.int32, device=dev)
    nb3 = cell3[:, None, :] + offs[None]  # (cap, 27, 3)
    dims = torch.tensor(grid_cfg.grid_size, dtype=torch.int32, device=dev)
    inb = torch.all((nb3 >= 0) & (nb3 < dims), dim=-1)
    cellflat = grids.flat_cell_index(torch.minimum(torch.clamp(nb3, min=0), dims - 1), grid_cfg)
    k_iota = torch.arange(kc, dtype=torch.int32, device=dev)
    slot_idx = (k_iota[None, None, :] * num_cells + cellflat[..., None]).long()  # (cap, 27, KC)

    nbp = res_pos.reshape(3, kc * num_cells)[:, slot_idx]  # (3, cap, 27, KC)
    nbm = res_mask.reshape(kc * num_cells)[slot_idx] * inb[..., None].to(res_mask.dtype)

    pt = p.t()
    d2 = sum((pt[i][:, None, None] - nbp[i]) ** 2 for i in range(3))
    w = _pair_weight(d2, re2) * nbm
    spring = torch.stack(
        [torch.sum(w * (pt[i][:, None, None] - nbp[i]), dim=(1, 2)) for i in range(3)], dim=-1
    )
    return idx, spring * ok[:, None].to(spring.dtype)


def correct_positions(
    position: torch.Tensor,
    active: torch.Tensor,
    slot_grid: slots_mod.SlotGrid,
    cfg: SimConfig,
    dt,
    seed: int,
    trunc_start=None,
) -> torch.Tensor:
    """Corrected particle positions (slot order, matching the slot grid).

    `seed` is the substep's jitter seed (the JAX package derives it from a
    key with ``jitterhash.seed_from_key``; see :class:`step.Draws`)."""
    dtype = position.dtype
    dev = position.device
    # h / sqrt(2) rounded as in float32, without a host-to-device copy
    re = float(np.float32(cfg.cell_size) / np.sqrt(np.float32(2.0)))
    kc = min(cfg.correction_capacity, slot_grid.capacity)
    window = kc * cfg.num_cells

    res_pos = slot_grid.position[:, :kc]  # (3, KC, nx, ny, nz)
    res_mask = slot_grid.mask[:kc]  # (KC, nx, ny, nz)
    re2 = cfg.cell_size * cfg.cell_size / 2.0
    springs = _springs(res_pos, res_mask, seed, _ZERO_ORIGIN, re2, cfg)

    # slot springs -> particles (slot rank*num_cells + cell is unchanged by
    # keeping ranks < KC only)
    slot_of = torch.clamp(slot_grid.slot_of, max=window)
    spring = slots_mod.gather_per_particle(springs, slot_grid._replace(slot_of=slot_of))

    truncated = active & (slot_grid.slot_of >= window)
    oidx, ospring = overflow_springs(
        position, truncated, res_pos, res_mask, re2, cfg,
        cfg.correction_overflow_capacity, trunc_start=trunc_start,
    )
    n = position.shape[0]
    ospring = torch.where((oidx < n)[:, None], ospring, torch.zeros_like(ospring))
    spring = spring.index_add(0, torch.clamp(oidx, max=n - 1).long(), ospring)

    new_pos = position + spring * (dt * cfg.correction_stiffness * re)
    lo = torch.tensor(cfg.domain_min, dtype=dtype, device=dev)
    hi = torch.tensor(cfg.domain_max, dtype=dtype, device=dev)
    new_pos = torch.minimum(torch.maximum(new_pos, lo), hi)
    return torch.where(active[:, None], new_pos, position)
