"""Particle<->grid transfers for PIC, FLIP and APIC (port of
``libfluid_tpu.sim.transfers``).

P2G runs from the dense slot grid (:func:`p2g_slots`): every face sums the
hat-weighted momentum of the slots in its staggered support
(:func:`kernels.p2g_faces`, kernel B), then the particles past the slot
capacity are scatter-added and faces normalize by total weight
(:func:`kernels.p2g_overflow` on CUDA tensors, :func:`_merge_overflow`
with :func:`_p2g_axis` on CPU tensors). G2P (:func:`g2p_pic`, kernel D)
interpolates the velocity and its gradient rows (the APIC affine matrix)
from the 54 face samples around each particle's cell; FLIP
(:func:`g2p_flip`) blends trilinear samples of the new and old grids.
Weights are computed in cell units.

Both are differentiable: on CUDA tensors the backward of kernel B is
kernel B' (``csrc/p2g_bwd.cu``), that of the overflow merge the plain
merge's autograd, and that of G2P kernel D' (``csrc/g2p_bwd.cu``); on CPU
tensors it is the autograd of the plain version. The hats take the JAX package's subgradients (:func:`hat`).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from libfluid_tpu_torch import grids, profiling
from libfluid_tpu_torch.config import SimConfig, TransferScheme
from libfluid_tpu_torch.sim import kernels
from libfluid_tpu_torch.sim import slots as slots_mod

_WEIGHT_EPS = 1e-6

_OFFSETS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def hat(t: torch.Tensor) -> torch.Tensor:
    """The trilinear hat max(1 - |t|, 0), with the subgradients of the JAX
    package's ``jnp.maximum(1 - jnp.abs(t), 0)``: slope -1 at t = 0 (where
    ``torch.abs`` has 0) and half the slope at |t| = 1 (where
    ``torch.clamp`` passes all of it)."""
    a = torch.where(t >= 0, t, -t)
    return torch.maximum(1.0 - a, torch.zeros_like(a))


def _face_world_shift(cfg: SimConfig, axis: int, device) -> torch.Tensor:
    """World offset of face (i,j,k) of `axis` from offset + h*(i,j,k)."""
    shift = [0.5, 0.5, 0.5]
    shift[axis] = 0.0
    return torch.tensor(shift, dtype=cfg.dtype, device=device) * cfg.cell_size


def _p2g_axis(position, value, affine_row, active, cfg: SimConfig, axis: int):
    """Scatter one velocity component to its face array; returns the
    UNNORMALIZED (momentum, weight) face arrays."""
    nx, ny, nz = cfg.grid_size
    shape = [nx, ny, nz]
    shape[axis] += 1
    dev = position.device
    dims = torch.tensor(shape, dtype=torch.int32, device=dev)

    coords = grids.face_index_coords(position, cfg, axis)
    base = torch.floor(coords).to(torch.int32)
    frac = coords - base

    size = shape[0] * shape[1] * shape[2]
    # one extra bin takes the masked contributions and is dropped
    num = torch.zeros(size + 1, dtype=cfg.dtype, device=dev)
    den = torch.zeros(size + 1, dtype=cfg.dtype, device=dev)
    world_base = torch.tensor(cfg.grid_offset, dtype=cfg.dtype, device=dev) + _face_world_shift(
        cfg, axis, dev
    )

    for off in _OFFSETS:
        offv = torch.tensor(off, dtype=torch.int32, device=dev)
        sel = torch.tensor(off, dtype=torch.bool, device=dev)
        idx = base + offv
        w = torch.prod(torch.where(sel, frac, 1.0 - frac), dim=-1)
        inb = torch.all((idx >= 0) & (idx < dims), dim=-1) & active
        w = torch.where(inb, w, torch.zeros_like(w))
        if affine_row is not None:
            face_pos = world_base + idx.to(cfg.dtype) * cfg.cell_size
            val = value + torch.sum(affine_row * (face_pos - position), dim=-1)
        else:
            val = value
        flat = (idx[..., 0] * shape[1] + idx[..., 1]) * shape[2] + idx[..., 2]
        flat = torch.where(inb, flat, torch.full_like(flat, size)).long()
        num.index_add_(0, flat, w * val)
        den.index_add_(0, flat, w)

    return num[:size].reshape(shape), den[:size].reshape(shape)


def _normalize(num, den):
    return torch.where(
        den > _WEIGHT_EPS, num / torch.clamp(den, min=_WEIGHT_EPS), torch.zeros_like(num)
    )


def p2g(
    position: torch.Tensor,
    velocity: torch.Tensor,
    affine: torch.Tensor,
    active: torch.Tensor,
    cfg: SimConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter-form particle-to-grid transfer (port of ``transfers.p2g``):
    normalized (u, v, w) face arrays; the affine rows add the APIC term for
    the APIC scheme only."""
    use_affine = cfg.scheme == TransferScheme.APIC
    out = []
    for axis in range(3):
        num, den = _p2g_axis(
            position, velocity[:, axis], affine[:, axis, :] if use_affine else None,
            active, cfg, axis,
        )
        out.append(_normalize(num, den))
    return tuple(out)


def _face_axes_of_offset(d):
    """Axes whose staggered support includes cell-relative face offset d:
    axis a participates iff d[a] != -1."""
    return [a for a in range(3) if d[a] != -1]


def _add_shifted_face(acc: torch.Tensor, ctr: torch.Tensor, d, axis: int) -> None:
    """acc[f] += ctr[c] for f = c + d, in place, cropping f outside the face
    array (along `axis` d in {0,1} is always in bounds)."""
    acc_sl, ctr_sl = [], []
    for dim in range(3):
        n = ctr.shape[dim]
        if dim == axis:
            acc_sl.append(slice(d[dim], n + d[dim]))
            ctr_sl.append(slice(None))
        elif d[dim] == -1:
            acc_sl.append(slice(0, n - 1))
            ctr_sl.append(slice(1, n))
        elif d[dim] == 0:
            acc_sl.append(slice(None))
            ctr_sl.append(slice(None))
        else:
            acc_sl.append(slice(1, n))
            ctr_sl.append(slice(0, n - 1))
    acc[tuple(acc_sl)] += ctr[tuple(ctr_sl)]


def _p2g_slots_torch(data: torch.Tensor, cfg: SimConfig):
    """Plain version of :func:`kernels.p2g_faces` (port of
    ``transfers._p2g_slots_jnp``): one pass per (offset, axis) pair."""
    nx, ny, nz = cfg.grid_size
    h = cfg.cell_size
    dev = data.device
    use_affine = cfg.scheme == TransferScheme.APIC
    sg = slots_mod.SlotGrid(data=data, slot_of=None, overflow=None)

    pos = sg.position  # (3, K, nx, ny, nz)
    mask = sg.mask  # (K, nx, ny, nz)
    vel = sg.velocity
    off = torch.tensor(cfg.grid_offset, dtype=cfg.dtype, device=dev)
    gpos = (pos - off.reshape(3, 1, 1, 1, 1)) / h

    cell_iota = [
        torch.arange(n, dtype=torch.int32, device=dev).reshape(
            [1] + [n if d == dim else 1 for d, n in enumerate((nx, ny, nz))]
        )
        for dim, n in enumerate((nx, ny, nz))
    ]

    shapes = [(nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)]
    num = [torch.zeros(s, dtype=cfg.dtype, device=dev) for s in shapes]
    den = [torch.zeros(s, dtype=cfg.dtype, device=dev) for s in shapes]

    for d in slots_mod.NEIGHBOR_OFFSETS:
        for axis in _face_axes_of_offset(d):
            shift = [0.5, 0.5, 0.5]
            shift[axis] = 0.0
            w = mask
            for dim in range(3):
                t = gpos[dim] - shift[dim] - (cell_iota[dim] + d[dim]).to(cfg.dtype)
                w = w * hat(t)
            val = vel[axis]
            if use_affine:
                arow = sg.affine_row(axis)
                for dim in range(3):
                    face_dim = (
                        (cell_iota[dim] + d[dim]).to(cfg.dtype) + shift[dim]
                    ) * h + cfg.grid_offset[dim]
                    val = val + arow[dim] * (face_dim - pos[dim])
            _add_shifted_face(num[axis], torch.sum(w * val, dim=0), d, axis)
            _add_shifted_face(den[axis], torch.sum(w, dim=0), d, axis)

    return tuple(num), tuple(den)


def overflow_window(cfg: SimConfig, n: int) -> int:
    """Rows of the overflow window: ``p2g_overflow_capacity``, at least 256
    and at most the `n` particles."""
    return min(max(256, cfg.p2g_overflow_capacity), n)


def _overflow_rows(overflow, n: int, cfg: SimConfig, start=None, rows=None):
    """The window's rows (int32, n where none): `rows` as given, or those of
    the ``overflow_window`` rows from `start` that are flagged `overflow`."""
    if rows is not None:
        return rows
    idx = start + torch.arange(overflow_window(cfg, n), dtype=torch.int32, device=overflow.device)
    safe_idx = torch.clamp(idx, max=n - 1).long()
    keep = overflow[safe_idx] & (idx < n)
    return torch.where(keep, idx, torch.full_like(idx, n))


def _merge_overflow(num, den, position, velocity, affine, active, idx, cfg: SimConfig):
    """Plain version of ``kernels.p2g_overflow``: scatter-add rows `idx`
    (n where none) to the face sums (:func:`_p2g_axis`), then normalise."""
    n = position.shape[0]
    use_affine = cfg.scheme == TransferScheme.APIC
    ok = idx < n
    safe = torch.clamp(idx, max=n - 1).long()
    pos_o = position[safe]
    vel_o = velocity[safe]
    aff_o = affine[safe] if use_affine else None
    act_o = ok & active[safe]
    out = []
    for axis in range(3):
        n_o, d_o = _p2g_axis(
            pos_o, vel_o[:, axis], aff_o[:, axis, :] if use_affine else None,
            act_o, cfg, axis,
        )
        out.append(_normalize(num[axis] + n_o, den[axis] + d_o))
    return tuple(out)


def p2g_slots(
    slot_grid,
    position: torch.Tensor,
    velocity: torch.Tensor,
    affine: torch.Tensor,
    active: torch.Tensor,
    cfg: SimConfig,
    overflow_start=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense particle-to-grid transfer from the cell-slot grid; returns the
    normalized (u, v, w) face arrays.

    Particles past the slot capacity (``slot_grid.overflow``) are merged
    exactly by a scatter pass, up to ``cfg.p2g_overflow_capacity`` of them.
    With ``overflow_start`` (slotsort parks overflow rows contiguously at
    ``[n_kept, n_kept + n_overflow)``) the compaction is a fixed window.
    `position/velocity/affine/active` are the arrays the slot grid was built
    from. On CUDA tensors the merge and the normalisation are two kernels
    (:func:`kernels.p2g_overflow`), counted as ``p2g_overflow.kernel``; on
    CPU tensors the plain :func:`_merge_overflow`, ``p2g_overflow.plain``.
    """
    num, den = kernels.p2g_faces(slot_grid.data, cfg)

    n = position.shape[0]
    rows = None
    if overflow_start is None:
        cap = overflow_window(cfg, n)
        with profiling.blocking("p2g.nonzero"):
            found = torch.nonzero(slot_grid.overflow).flatten()[:cap].to(torch.int32)
        rows = torch.full((cap,), n, dtype=torch.int32, device=position.device)
        rows[: found.shape[0]] = found
    if kernels.use_kernel(position):
        profiling.count("p2g_overflow.kernel")
        return kernels.p2g_overflow(num, den, position, velocity, affine, active,
                                    slot_grid.overflow, cfg, start=overflow_start, rows=rows)
    profiling.count("p2g_overflow.plain")
    idx = _overflow_rows(slot_grid.overflow, n, cfg, overflow_start, rows)
    return _merge_overflow(num, den, position, velocity, affine, active, idx, cfg)


# ---------------------------------------------------------------------------
# G2P
# ---------------------------------------------------------------------------


def _cell_offsets(axis: int):
    """The 18 face offsets relative to a particle's CELL index: {0,1} along
    the face axis, {-1,0,1} along the other two."""
    ranges = [(-1, 0, 1)] * 3
    ranges[axis] = (0, 1)
    return [
        (dx, dy, dz) for dx in ranges[0] for dy in ranges[1] for dz in ranges[2]
    ]


def _stacked_shifts(arr: torch.Tensor, offsets, axis: int) -> torch.Tensor:
    """(len(offsets), num_cells) table: row t holds arr[cell + offsets[t]],
    zero outside the face array's transverse extent."""
    pad = [1, 1, 1, 1, 1, 1]  # F.pad order: z lo/hi, y lo/hi, x lo/hi
    pad[2 * (2 - axis)] = 0
    pad[2 * (2 - axis) + 1] = 0
    padded = F.pad(arr, pad)
    nx, ny, nz = [arr.shape[d] - (1 if d == axis else 0) for d in range(3)]
    cols = []
    for off in offsets:
        sx, sy, sz = [off[d] + (0 if d == axis else 1) for d in range(3)]
        cols.append(padded[sx : sx + nx, sy : sy + ny, sz : sz + nz])
    return torch.stack(cols, dim=0).reshape(len(offsets), nx * ny * nz)


def build_g2p_table(grid: grids.MacGrid, cfg: SimConfig) -> torch.Tensor:
    """(C, 54) per-cell sample table: the face samples of all 3 axes' 18
    cell-relative offsets."""
    tables = [
        _stacked_shifts(arr, _cell_offsets(axis), axis)
        for axis, arr in enumerate((grid.u, grid.v, grid.w))
    ]
    return torch.cat(tables, dim=0).t().contiguous()


def g2p_from_table(
    table: torch.Tensor, position: torch.Tensor, cfg: SimConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-particle velocity (N, 3) and APIC affine (N, 3, 3) from the sample
    table."""
    cell3c = grids.cell_index_of(position, cfg)
    samples_all = table[grids.flat_cell_index(cell3c, cfg).long()]  # (N, 54)
    dev = position.device

    vals = []
    rows_out = []
    for axis in range(3):
        offsets = torch.tensor(_cell_offsets(axis), dtype=torch.int32, device=dev)
        samples = samples_all[:, 18 * axis : 18 * (axis + 1)]  # (N, 18)
        coords = grids.face_index_coords(position, cfg, axis)
        f = cell3c[:, None, :] + offsets[None]  # (N, 18, 3)
        d = coords[:, None, :] - f.to(cfg.dtype)
        n = hat(d)
        w = torch.prod(n, dim=-1)  # (N, 18)
        vals.append(torch.sum(w * samples, dim=-1))
        # derivative factor of the hat on the HALF-OPEN support [-1, 1)
        one = torch.ones_like(d)
        s = torch.where(
            (d >= -1.0) & (d < 1.0), torch.where(d > 0.0, -one, one), torch.zeros_like(d)
        )
        g = torch.stack(
            [
                s[..., 0] * n[..., 1] * n[..., 2],
                n[..., 0] * s[..., 1] * n[..., 2],
                n[..., 0] * n[..., 1] * s[..., 2],
            ],
            dim=-1,
        ) / cfg.cell_size  # (N, 18, 3)
        rows_out.append(torch.sum(g * samples[..., None], dim=1))
    return torch.stack(vals, dim=-1), torch.stack(rows_out, dim=-2)


def _check_g2p(u, v, w, position, cfg: SimConfig) -> int:
    """Raise unless the faces and positions are what kernels D and D' take;
    returns the number of particles."""
    nx, ny, nz = cfg.grid_size
    n = position.shape[0]
    if max((nx + 1) * ny * nz, nx * (ny + 1) * nz, nx * ny * (nz + 1)) >= 1 << 31:
        raise ValueError(f"grid {cfg.grid_size}: the G2P kernels index a face array with 32 bits")
    kernels.check(u, torch.float32, (nx + 1, ny, nz), "u")
    kernels.check(v, torch.float32, (nx, ny + 1, nz), "v")
    kernels.check(w, torch.float32, (nx, ny, nz + 1), "w")
    kernels.check(position, torch.float32, (n, 3), "position")
    return n


def _g2p_cuda(u, v, w, position, cfg: SimConfig):
    nx, ny, nz = cfg.grid_size
    n = _check_g2p(u, v, w, position, cfg)
    vel = torch.empty((n, 3), dtype=torch.float32, device=position.device)
    aff = torch.empty((n, 3, 3), dtype=torch.float32, device=position.device)
    ox, oy, oz = (float(o) for o in cfg.grid_offset)
    kernels.launch(
        "g2p", "lf_g2p", u, v, w, position, vel, aff, n,
        nx, ny, nz, float(cfg.cell_size), ox, oy, oz,
    )
    return vel, aff


def _g2p_plain(u, v, w, position, cfg: SimConfig):
    grid = grids.MacGrid(u, v, w, None)
    return g2p_from_table(build_g2p_table(grid, cfg), position, cfg)


def g2p_bwd(u, v, w, position, gvel, gaff, cfg: SimConfig):
    """Kernel D', the adjoint of kernel D on CUDA tensors: the cotangents of
    (u, v, w, position) from those of the velocity (N, 3) and the affine
    matrix (N, 3, 3). The face cotangents are summed with atomics (in a
    block's shared-memory box first where the particles' order allows, then
    in device memory), so their last bits vary from run to run."""
    nx, ny, nz = cfg.grid_size
    n = _check_g2p(u, v, w, position, cfg)
    gvel = gvel.contiguous()
    gaff = gaff.contiguous()
    kernels.check(gvel, torch.float32, (n, 3), "velocity cotangent")
    kernels.check(gaff, torch.float32, (n, 3, 3), "affine cotangent")
    # one zero fill for the three face cotangents
    sizes = [a.numel() for a in (u, v, w)]
    flat = torch.zeros(sum(sizes), dtype=torch.float32, device=u.device)
    gu, gv, gw = (g.view(a.shape) for g, a in zip(torch.split(flat, sizes), (u, v, w)))
    gpos = torch.empty_like(position)
    ox, oy, oz = (float(o) for o in cfg.grid_offset)
    kernels.launch(
        "g2p_bwd", "lf_g2p_bwd", u, v, w, position, gvel, gaff, gu, gv, gw, gpos, n,
        nx, ny, nz, float(cfg.cell_size), ox, oy, oz,
    )
    return gu, gv, gw, gpos


class _G2P(torch.autograd.Function):
    """Kernel D and its adjoint D' on CUDA tensors; the plain version and
    its autograd (recomputed in backward) on CPU tensors."""

    @staticmethod
    def forward(ctx, u, v, w, position, cfg):
        ctx.cfg = cfg
        ctx.save_for_backward(u, v, w, position)
        if not kernels.use_kernel(u, v, w, position):
            return _g2p_plain(u, v, w, position, cfg)
        return _g2p_cuda(u, v, w, position, cfg)

    @staticmethod
    def backward(ctx, gvel, gaff):
        u, v, w, position = ctx.saved_tensors
        if kernels.use_kernel(u, v, w, position):
            return (*g2p_bwd(u, v, w, position, gvel, gaff, ctx.cfg), None)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (u, v, w, position)]
            out = _g2p_plain(*leaves, ctx.cfg)
            grads = torch.autograd.grad(out, leaves, (gvel, gaff), allow_unused=True)
        return (*grads, None)


def g2p_pic(
    grid: grids.MacGrid, position: torch.Tensor, cfg: SimConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """PIC/APIC grid-to-particle: interpolated velocity (N, 3) and the APIC
    affine matrix (N, 3, 3), rows = gradients of each component.

    Replaces ``libfluid_tpu/sim/transfers.py:_transpose_major`` and
    ``_transpose_rows`` (the two layout-pinning kernels of G2P) with the
    whole of ``g2p_pic``. CUDA: ``csrc/g2p.cu``, backward
    ``csrc/g2p_bwd.cu``; CPU: the plain :func:`build_g2p_table` +
    :func:`g2p_from_table`.
    """
    return _G2P.apply(grid.u, grid.v, grid.w, position, cfg)


def g2p_flip(
    new_grid: grids.MacGrid,
    old_grid: grids.MacGrid,
    position: torch.Tensor,
    velocity: torch.Tensor,
    cfg: SimConfig,
) -> torch.Tensor:
    """FLIP blend v_new_grid + blend * (v_particle - v_old_grid) (port of
    ``transfers.g2p_flip``); plain trilinear gathers, as in the JAX
    package."""
    v_new = grids.velocity_at(new_grid, position, cfg)
    v_old = grids.velocity_at(old_grid, position, cfg)
    return v_new + (velocity - v_old) * cfg.blending_factor
