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
deterministic hash jitter (:mod:`libfluid_tpu_torch.sim.jitterhash`) scaled
by the slot's coincident count. Particles past the window (rank >= kc,
slot overflow included) get a compacted per-particle pass against the
resident field, :func:`overflow_springs`, up to
``correction_overflow_capacity`` of them.
"""

from __future__ import annotations

import numpy as np
import torch

from libfluid_tpu_torch import grids, profiling
from libfluid_tpu_torch.config import SimConfig
from libfluid_tpu_torch.sim import jitterhash, kernels
from libfluid_tpu_torch.sim import slots as slots_mod

_ZERO_ORIGIN = (0, 0, 0)


def _pair_weight(sq: torch.Tensor, re2: float) -> torch.Tensor:
    """(1 - sq/re2)^3 / sqrt(sq), zero for degenerate (sq < 1e-12) pairs."""
    kern = torch.clamp(1.0 - sq / re2, min=0.0) ** 3
    w = kern * torch.rsqrt(torch.clamp(sq, min=1e-12))
    return torch.where(sq < 1e-12, torch.zeros_like(w), w)


def _springs_torch(
    res_pos: torch.Tensor, res_mask: torch.Tensor, re2: float, seed: int,
    cfg: SimConfig, origin=_ZERO_ORIGIN,
) -> torch.Tensor:
    """Per-slot springs (3, KC, nx, ny, nz), plain version of kernel E (port
    of ``correction._springs_jnp``): for each of the 27 offsets the
    neighbour cell's slots are a shifted copy of the slot grid, and the
    (KC, KC) pairs reduce over the neighbour axis."""
    kc = res_pos.shape[1]
    wsum = torch.zeros_like(res_mask)
    wnbr = torch.zeros_like(res_pos)
    coincident = torch.zeros_like(res_mask)
    eye = torch.eye(kc, dtype=res_pos.dtype, device=res_pos.device).reshape(kc, kc, 1, 1, 1)

    for d in slots_mod.NEIGHBOR_OFFSETS:
        nbr_pos = slots_mod.shifted(res_pos, d, cfg)
        nbr_mask = slots_mod.shifted(res_mask, d, cfg)
        # pairwise (KC res, KC nbr, nx, ny, nz)
        sq = sum((res_pos[i][:, None] - nbr_pos[i][None, :]) ** 2 for i in range(3))
        pair = res_mask[:, None] * nbr_mask[None, :]
        if d == (0, 0, 0):
            pair = pair * (1.0 - eye)  # a slot is not its own neighbour
        w = _pair_weight(sq, re2) * pair
        wsum += torch.sum(w, dim=1)
        wnbr += torch.stack([torch.sum(w * nbr_pos[i][None, :], dim=1) for i in range(3)])
        coincident += torch.sum(torch.where(sq < 1e-12, pair, torch.zeros_like(pair)), dim=1)

    springs = res_pos * wsum[None] - wnbr
    jitter = jitterhash.jitter_field(
        seed, kc, tuple(res_pos.shape[2:]), origin, res_pos.dtype, res_pos.device
    )
    return springs + coincident[None] * jitter


def _springs_vjp_torch(
    res_pos: torch.Tensor, res_mask: torch.Tensor, g: torch.Tensor, re2: float, seed: int,
    cfg: SimConfig, origin=_ZERO_ORIGIN,
):
    """Cotangents (d res_pos, d res_mask) of :func:`_springs_torch` for the
    springs' cotangent ``g`` (3, KC, nx, ny, nz), in closed form: the plain
    version of kernel E' (``csrc/correction_bwd.cu``), equal to ``jax.vjp``
    of ``correction._springs_jnp``.

    Every pair stands in both slots' sums (a neighbour outside the grid is
    masked on both sides), so with r = x_i - x_j, G = g_i - g_j,
    w(s) = max(1 - s/re2, 0)^3 / sqrt(s) and w' its slope,

        d x_i = m_i sum_j m_j (w G + 2 w' (r . G) r)
        d m_i = sum_j m_j (w r . G + [coincident] (jitter_i . g_i + jitter_j . g_j))

    over the slots j of the 27 neighbour cells, the slot itself excluded: a
    gather, as the forward is. The oracle's rules at the kinks: the cube has
    slope 0 where 1 - s/re2 crosses 0, and a coincident pair (s < 1e-12)
    passes nothing to the positions. The kernel writes 0 for empty slots;
    this gives their mask the oracle's value."""
    kc = res_pos.shape[1]
    d_pos = torch.zeros_like(res_pos)
    d_mask = torch.zeros_like(res_mask)
    eye = torch.eye(kc, dtype=res_pos.dtype, device=res_pos.device).reshape(kc, kc, 1, 1, 1)
    jitter = jitterhash.jitter_field(
        seed, kc, tuple(res_pos.shape[2:]), origin, res_pos.dtype, res_pos.device
    )
    jg = torch.sum(jitter * g, dim=0)  # (KC, nx, ny, nz)

    for d in slots_mod.NEIGHBOR_OFFSETS:
        nbr_pos = slots_mod.shifted(res_pos, d, cfg)
        nbr_mask = slots_mod.shifted(res_mask, d, cfg)
        nbr_g = slots_mod.shifted(g, d, cfg)
        nbr_jg = slots_mod.shifted(jg, d, cfg)
        # pairwise (KC res, KC nbr, nx, ny, nz)
        r = [res_pos[i][:, None] - nbr_pos[i][None, :] for i in range(3)]
        dg = [g[i][:, None] - nbr_g[i][None, :] for i in range(3)]
        sq = r[0] ** 2 + r[1] ** 2 + r[2] ** 2
        r_dg = r[0] * dg[0] + r[1] * dg[1] + r[2] * dg[2]
        m_nbr = nbr_mask[None, :].expand(kc, kc, *nbr_mask.shape[1:])
        if d == (0, 0, 0):
            m_nbr = m_nbr * (1.0 - eye)  # a slot is not its own neighbour
        degenerate = sq < 1e-12
        zero = torch.zeros_like(sq)
        kern = torch.clamp(1.0 - sq / re2, min=0.0)
        rs = torch.rsqrt(torch.clamp(sq, min=1e-12))
        w = torch.where(degenerate, zero, kern**3 * rs) * m_nbr
        # 2 w' = -k^2 / sqrt(s) * (6 / re2 + k / s)
        w2 = torch.where(degenerate, zero, -kern * kern * rs * (6.0 / re2 + kern * rs * rs)) * m_nbr
        d_pos += torch.stack([torch.sum(w * dg[i] + w2 * r_dg * r[i], dim=1) for i in range(3)])
        both = jg[:, None] + nbr_jg[None, :]
        d_mask += torch.sum(w * r_dg + torch.where(degenerate, m_nbr * both, zero), dim=1)
    return d_pos * res_mask[None], d_mask


class _Springs(torch.autograd.Function):
    """Kernel E forward and kernel E' backward on CUDA tensors;
    :func:`_springs_torch` and its autograd, recomputed in backward, on CPU
    tensors (port of ``correction._springs_bwd``, which takes ``jax.vjp`` of
    the jnp oracle). An empty slot's mask cotangent is 0 from E' and the
    oracle's value from the autograd; ``slotsort``'s expand writes back the
    valid slots only, so it is dropped with the slot either way."""

    @staticmethod
    def forward(ctx, res_pos, res_mask, seed, origin, re2, cfg):
        ctx.args = (seed, origin, re2, cfg)
        ctx.save_for_backward(res_pos, res_mask)
        if not kernels.use_kernel(res_pos, res_mask):
            return _springs_torch(res_pos, res_mask, re2, seed, cfg, origin)
        return kernels.correction_springs(res_pos, res_mask, re2, seed, origin)

    @staticmethod
    def backward(ctx, g):
        seed, origin, re2, cfg = ctx.args
        res_pos, res_mask = ctx.saved_tensors
        if kernels.use_kernel(res_pos, res_mask, g):
            dp, dm = kernels.correction_springs_bwd(
                res_pos, res_mask, g, re2, seed, origin, need_mask=ctx.needs_input_grad[1]
            )
            return dp, dm, None, None, None, None
        with torch.enable_grad():
            p = res_pos.detach().requires_grad_()
            m = res_mask.detach().requires_grad_()
            out = _springs_torch(p, m, re2, seed, cfg, origin)
            dp, dm = torch.autograd.grad(out, (p, m), g)
        return dp, dm, None, None, None, None


def _springs(res_pos, res_mask, seed: int, origin, re2: float, cfg: SimConfig) -> torch.Tensor:
    """Kernels E and E' on CUDA tensors, :func:`_springs_torch` and its
    autograd on CPU tensors."""
    return _Springs.apply(res_pos, res_mask, seed, origin, re2, cfg)


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
        with profiling.blocking("correction.nonzero"):
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
    return move(position, active, spring, oidx, ospring, cfg, dt)


def move(position, active, spring, oidx, ospring, cfg: SimConfig, dt) -> torch.Tensor:
    """The corrected positions: the per-particle springs `spring` (N, 3) plus
    the overflow rows' `ospring` at rows `oidx` (n where unused), a step of
    dt * stiffness * re along them, clamped into the domain (no skin);
    inactive rows keep their positions."""
    n = position.shape[0]
    ospring = torch.where((oidx < n)[:, None], ospring, torch.zeros_like(ospring))
    spring = spring.index_add(0, torch.clamp(oidx, max=n - 1).long(), ospring)
    # h / sqrt(2) rounded as in float32, without a host-to-device copy
    re = float(np.float32(cfg.cell_size) / np.sqrt(np.float32(2.0)))
    new_pos = position + spring * (dt * cfg.correction_stiffness * re)
    lo = torch.tensor(cfg.domain_min, dtype=position.dtype, device=position.device)
    hi = torch.tensor(cfg.domain_max, dtype=position.dtype, device=position.device)
    new_pos = torch.minimum(torch.maximum(new_pos, lo), hi)
    return torch.where(active[:, None], new_pos, position)
