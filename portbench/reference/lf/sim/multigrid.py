"""Geometric multigrid preconditioner for the pressure Poisson solve (port of
``libfluid_tpu.sim.multigrid``).

A matrix-free V-cycle: 2x coarsening with cell-type rediscretization,
damped-Jacobi smoothing, cell-centred trilinear prolongation P and its exact
transpose R = P^T / 8 as restriction, per-level operator scale 4^-l. One
pass of the masked 7-point stencil (:func:`stencil`, kernel C) is the CG
operator. The cycle (:func:`v_cycle`), in float32 and in the bfloat16 of
"mg16", is fused into four stage kernels (``csrc/vcycle.cu``), each with
its plain version here; on CPU tensors the cycle is composed of exactly
those plain stages. :func:`v_cycle_per_pass`, one stencil pass a launch, is
the yardstick the fused cycle is timed and held against.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import torch

from portbench.reference.lf.config import CellType
from portbench.reference.lf.grids import pad1

_MAX_LEVELS = 6  # of a hierarchy, and of the coarse kernel's argument block
_SMOOTH_DAMP = 0.8  # damped-Jacobi weight
_PRE_SMOOTH = 2
_POST_SMOOTH = 2
_COARSE_ITERS = 12  # Jacobi iterations on the coarsest level
_MIN_SIZE = 8  # stop coarsening at <= this many cells per axis

# stencil modes (csrc/stencil.cu)
MODE_APPLY, MODE_JACOBI, MODE_RESIDUAL = 0, 1, 2


@functools.lru_cache(maxsize=None)
def _weak(value: float, dtype: torch.dtype) -> float:
    """A scalar as an operation of `dtype` sees it in the JAX package, whose
    Python scalars are weakly typed: in bfloat16 the nearest bfloat16
    value (0.8 -> 0.80078125), else `value`."""
    if dtype == torch.bfloat16:
        return float(torch.tensor(value, dtype=torch.bfloat16))
    return value


class MGLevel(NamedTuple):
    fluid: torch.Tensor  # (nx, ny, nz) 1.0 on fluid
    diag: torch.Tensor  # #non-solid neighbors on fluid cells
    inv_diag: torch.Tensor  # 1 / (scale * diag) on fluid cells
    couple_u: torch.Tensor  # (nx+1, ny, nz) 1.0 where the face joins two fluid cells
    couple_v: torch.Tensor
    couple_w: torch.Tensor
    scale: float  # 4^-l relative to the finest level


def _operator_from_types(ct: torch.Tensor, scale: float, dtype) -> MGLevel:
    solid = ct == CellType.SOLID
    fluid_b = ct == CellType.FLUID
    sp = pad1(solid, True)
    nonsolid = (
        (~sp[:-2, 1:-1, 1:-1]).to(dtype)
        + (~sp[2:, 1:-1, 1:-1]).to(dtype)
        + (~sp[1:-1, :-2, 1:-1]).to(dtype)
        + (~sp[1:-1, 2:, 1:-1]).to(dtype)
        + (~sp[1:-1, 1:-1, :-2]).to(dtype)
        + (~sp[1:-1, 1:-1, 2:]).to(dtype)
    )
    fp = pad1(fluid_b, False)
    cu = (fp[:-1, 1:-1, 1:-1] & fp[1:, 1:-1, 1:-1]).to(dtype)
    cv = (fp[1:-1, :-1, 1:-1] & fp[1:-1, 1:, 1:-1]).to(dtype)
    cw = (fp[1:-1, 1:-1, :-1] & fp[1:-1, 1:-1, 1:]).to(dtype)
    fluid = fluid_b.to(dtype)
    diag = nonsolid * fluid
    inv_diag = torch.where(
        diag > 0, 1.0 / torch.clamp(diag * scale, min=1e-30), torch.zeros_like(diag)
    )
    return MGLevel(fluid, diag, inv_diag, cu, cv, cw, scale)


def _coarsen_types(ct: torch.Tensor) -> torch.Tensor:
    """2x coarsening of cell types (any-fluid > all-solid > air); odd axes
    are padded with SOLID (out of bounds is solid)."""
    nx, ny, nz = ct.shape
    px, py, pz = nx % 2, ny % 2, nz % 2
    if px or py or pz:
        padded = torch.full(
            (nx + px, ny + py, nz + pz), CellType.SOLID, dtype=ct.dtype, device=ct.device
        )
        padded[:nx, :ny, :nz] = ct
        ct = padded
    c = ct.reshape(ct.shape[0] // 2, 2, ct.shape[1] // 2, 2, ct.shape[2] // 2, 2)
    c = c.permute(0, 2, 4, 1, 3, 5).reshape(c.shape[0], c.shape[2], c.shape[4], 8)
    any_fluid = torch.any(c == CellType.FLUID, dim=-1)
    all_solid = torch.all(c == CellType.SOLID, dim=-1)
    out = torch.full(any_fluid.shape, CellType.AIR, dtype=torch.int8, device=ct.device)
    out[all_solid] = CellType.SOLID
    out[any_fluid] = CellType.FLUID
    return out


class Hierarchy(tuple):
    """The levels of :func:`build_levels`, finest first: a tuple that
    remembers once the fused kernels' wrappers have checked its arrays."""

    fused_checked = False


def build_levels(cell_type: torch.Tensor, dtype=torch.float32) -> Tuple[MGLevel, ...]:
    levels: List[MGLevel] = []
    ct = cell_type
    scale = 1.0
    while True:
        levels.append(_operator_from_types(ct, scale, dtype))
        if min(ct.shape) <= _MIN_SIZE or len(levels) >= _MAX_LEVELS:
            break
        ct = _coarsen_types(ct)
        scale *= 0.25
    return Hierarchy(levels)


# ---------------------------------------------------------------------------
# Kernel C: the masked 7-point stencil
# ---------------------------------------------------------------------------


def _apply_level_torch(level: MGLevel, p: torch.Tensor) -> torch.Tensor:
    """A_l p by static slices (port of the jnp path of ``apply_level``)."""
    p = p * level.fluid
    nbr = torch.zeros_like(p)
    nbr[1:] += level.couple_u[1:-1] * p[:-1]
    nbr[:-1] += level.couple_u[1:-1] * p[1:]
    nbr[:, 1:] += level.couple_v[:, 1:-1] * p[:, :-1]
    nbr[:, :-1] += level.couple_v[:, 1:-1] * p[:, 1:]
    nbr[:, :, 1:] += level.couple_w[:, :, 1:-1] * p[:, :, :-1]
    nbr[:, :, :-1] += level.couple_w[:, :, 1:-1] * p[:, :, 1:]
    return level.scale * (level.diag * p - nbr) * level.fluid


def _stencil_torch(level: MGLevel, x, b, mode: int, damp: float) -> torch.Tensor:
    """Plain version of :func:`stencil`; in bfloat16 every operation rounds
    to bfloat16, as PyTorch's bfloat16 arithmetic does."""
    ax = _apply_level_torch(level, x)
    if mode == MODE_APPLY:
        return ax
    if mode == MODE_JACOBI:
        return x + damp * level.inv_diag * (b - ax)
    return b - ax


def _smooth(level: MGLevel, x: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    for _ in range(iters):
        x = stencil(level, x, b, MODE_JACOBI, _SMOOTH_DAMP)
    return x * level.fluid


# ---------------------------------------------------------------------------
# Trilinear transfers: P interpolates, R = P^T / 8 exactly (edge fold included)
# ---------------------------------------------------------------------------


def _sl(arr: torch.Tensor, axis: int, start, stop, step=None) -> torch.Tensor:
    idx = [slice(None)] * arr.ndim
    idx[axis] = slice(start, stop, step)
    return arr[tuple(idx)]


def _interleave(lo: torch.Tensor, hi: torch.Tensor, axis: int) -> torch.Tensor:
    st = torch.stack([lo, hi], dim=axis + 1)
    shape = list(lo.shape)
    shape[axis] *= 2
    return st.reshape(shape)


def _prolong_axis(c: torch.Tensor, axis: int) -> torch.Tensor:
    """n -> 2n along axis: F[2j] = .75 C[j] + .25 C[j-1] (edge-clamped),
    F[2j+1] = .75 C[j] + .25 C[j+1]."""
    cp = torch.cat([_sl(c, axis, 0, 1), c, _sl(c, axis, -1, None)], dim=axis)
    ctr = _sl(cp, axis, 1, -1)
    lo = 0.75 * ctr + 0.25 * _sl(cp, axis, 0, -2)
    hi = 0.75 * ctr + 0.25 * _sl(cp, axis, 2, None)
    return _interleave(lo, hi, axis)


def _restrict_axis(f: torch.Tensor, axis: int) -> torch.Tensor:
    """EXACT transpose of :func:`_prolong_axis` (2n -> n along axis),
    including the fold of the edge-clamp contributions."""
    a = _sl(f, axis, 0, None, 2)  # even rows: .75 -> C[j], .25 -> C[j-1]
    b = _sl(f, axis, 1, None, 2)  # odd rows: .75 -> C[j], .25 -> C[j+1]
    c = 0.75 * (a + b)
    mless = 0.25 * a
    mplus = 0.25 * b
    zero = torch.zeros_like(_sl(mless, axis, 0, 1))
    c_shift_down = torch.cat([_sl(mless, axis, 1, None), zero], dim=axis)
    c_fold_lo = torch.zeros_like(c)
    _sl(c_fold_lo, axis, 0, 1).copy_(_sl(mless, axis, 0, 1))
    c_shift_up = torch.cat([zero, _sl(mplus, axis, 0, -1)], dim=axis)
    c_fold_hi = torch.zeros_like(c)
    _sl(c_fold_hi, axis, -1, None).copy_(_sl(mplus, axis, -1, None))
    return c + c_shift_down + c_fold_lo + c_shift_up + c_fold_hi


def _restrict(level_c: MGLevel, r: torch.Tensor) -> torch.Tensor:
    """R = P^T / 8 (trilinear), masked to coarse fluid cells."""
    nx, ny, nz = r.shape
    px, py, pz = nx % 2, ny % 2, nz % 2
    if px or py or pz:
        # the transpose of _prolong's crop is a zero-pad
        padded = r.new_zeros((nx + px, ny + py, nz + pz))
        padded[:nx, :ny, :nz] = r
        r = padded
    out = r
    for axis in range(3):
        out = _restrict_axis(out, axis)
    return out * 0.125 * level_c.fluid


def _prolong(e_c: torch.Tensor, fine_shape) -> torch.Tensor:
    e = e_c
    for axis in range(3):
        e = _prolong_axis(e, axis)
    return e[: fine_shape[0], : fine_shape[1], : fine_shape[2]]


def v_cycle_per_pass(levels: Tuple[MGLevel, ...], b: torch.Tensor, l: int = 0) -> torch.Tensor:
    """The V-cycle as one stencil pass per launch with PyTorch ops between
    the passes ("stencil" in float32, "stencil16" in bfloat16): the
    yardstick the fused cycle is timed against. In either dtype it is the
    plain cycle, operation for operation."""
    level = levels[l]
    if l == len(levels) - 1:
        return _smooth(level, torch.zeros_like(b), b, _COARSE_ITERS)
    x = _smooth(level, torch.zeros_like(b), b, _PRE_SMOOTH)
    r = residual(level, x, b)
    rc = _restrict(levels[l + 1], r)
    ec = v_cycle_per_pass(levels, rc, l + 1)
    x = x + _prolong(ec, b.shape) * level.fluid
    x = _smooth(level, x, b, _POST_SMOOTH)
    return x


# ---------------------------------------------------------------------------
# Kernel C, fused: the V-cycle in stages (csrc/vcycle.cu)
# ---------------------------------------------------------------------------


# A level of at most this many cells, and every level below it, runs inside
# the one-block kernel "mg_coarse"; the larger levels above take "mg_pre",
# "mg_restrict" and "mg_up", one launch each ("mg16_*" in bfloat16). The
# last level is always coarse; "mg_coarse" keeps its levels in shared memory
# where they fit (:func:`coarse_route`), else sweeps them out of device
# memory with one block, and a level above _COARSE_CELLS_MAX cells is
# refused (a hierarchy that ends so large: a thin slab, or more than
# _MAX_LEVELS halvings to go).
_COARSE_CELLS = 16 * 16 * 16


def _smooth_plain(level: MGLevel, x: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """:func:`_smooth` of the plain stages: the damping weight of b's dtype,
    as :func:`stencil` takes it."""
    damp = _weak(_SMOOTH_DAMP, b.dtype)
    for _ in range(iters):
        x = _stencil_torch(level, x, b, MODE_JACOBI, damp)
    return x * level.fluid


def _pre_torch(level: MGLevel, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`pre_smooth`."""
    return _smooth_plain(level, torch.zeros_like(b), b, _PRE_SMOOTH)


def _restrict_residual_torch(level: MGLevel, level_c: MGLevel, x, b) -> torch.Tensor:
    """Plain version of :func:`restrict_residual`."""
    r = _stencil_torch(level, x, b, MODE_RESIDUAL, 0.0) * level.fluid
    return _restrict(level_c, r)


def _up_torch(level: MGLevel, x, ec, b) -> torch.Tensor:
    """Plain version of :func:`prolong_smooth`."""
    x = x + _prolong(ec, b.shape) * level.fluid
    return _smooth_plain(level, x, b, _POST_SMOOTH)


def _coarse_torch(levels: Tuple[MGLevel, ...], b: torch.Tensor, l: int) -> torch.Tensor:
    """Plain version of :func:`coarse_cycle`: the sub-cycle from level `l`
    down, out of the plain stage functions."""
    level = levels[l]
    if l == len(levels) - 1:
        return _smooth_plain(level, torch.zeros_like(b), b, _COARSE_ITERS)
    x = _pre_torch(level, b)
    rc = _restrict_residual_torch(level, levels[l + 1], x, b)
    ec = _coarse_torch(levels, rc, l + 1)
    return _up_torch(level, x, ec, b)


def _coarse_shape(shape) -> Tuple[int, ...]:
    return tuple((n + 1) // 2 for n in shape)


def first_coarse_level(levels: Tuple[MGLevel, ...]) -> int:
    """The first level that :func:`coarse_cycle` takes."""
    for l, lev in enumerate(levels):
        if lev.fluid.numel() <= _COARSE_CELLS:
            return l
    return len(levels) - 1


def stencil(level: MGLevel, x: torch.Tensor, b: torch.Tensor, mode: int,
            damp: float = 0.0) -> torch.Tensor:
    """One stencil pass y = f(A x): MODE_APPLY gives A x, MODE_JACOBI the
    damped-Jacobi step x + damp * D^-1 (b - A x), MODE_RESIDUAL b - A x. In
    bfloat16 the damping weight is the bfloat16 value nearest to `damp`
    (:func:`_weak`)."""
    return _stencil_torch(level, x, b, mode, _weak(damp, x.dtype))


def apply_level(level: MGLevel, p: torch.Tensor) -> torch.Tensor:
    """A_l p."""
    return stencil(level, p, p, MODE_APPLY)


def residual(level: MGLevel, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(b - A x) * fluid."""
    return stencil(level, x, b, MODE_RESIDUAL) * level.fluid


def v_cycle(levels: Tuple[MGLevel, ...], b: torch.Tensor, l: int = 0) -> torch.Tensor:
    """One V-cycle from x = 0: the preconditioner M^-1 b up to the operator
    scale, composed of the plain stages (the port's cycle on CPU tensors)."""
    coarse = max(l, first_coarse_level(levels))
    xs, bs = [], [b]
    for m in range(l, coarse):
        xs.append(_pre_torch(levels[m], bs[-1]))
        bs.append(_restrict_residual_torch(levels[m], levels[m + 1], xs[-1], bs[-1]))
    e = _coarse_torch(levels, bs.pop(), coarse)
    for m in reversed(range(l, coarse)):
        e = _up_torch(levels[m], xs.pop(), e, bs.pop())
    return e
