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

import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import torch

from libfluid_tpu_torch.config import CellType
from libfluid_tpu_torch.grids import pad1
from libfluid_tpu_torch.sim import kernels

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


# kernel C's instances: dtype -> (launch count name, C entry point)
_STENCIL_KERNELS = {
    torch.float32: ("stencil", "lf_stencil"),
    torch.bfloat16: ("stencil16", "lf_stencil16"),
}


def stencil(level: MGLevel, x: torch.Tensor, b: torch.Tensor, mode: int,
            damp: float = 0.0) -> torch.Tensor:
    """One stencil pass y = f(A x): MODE_APPLY gives A x, MODE_JACOBI the
    damped-Jacobi step x + damp * D^-1 (b - A x), MODE_RESIDUAL b - A x.

    Replaces ``libfluid_tpu/sim/multigrid.py:_stencil_kernel`` (through
    ``_stencil_pass``). CUDA: ``csrc/stencil.cu``, on every level, float32
    ("stencil") or bfloat16 ("stencil16", the dtype of the JAX package's
    "mg16" cycle); CPU: :func:`_stencil_torch`. In bfloat16 the damping
    weight is taken as the bfloat16 value nearest to `damp` (:func:`_weak`).
    """
    damp = _weak(damp, x.dtype)
    if not kernels.use_kernel(x, b, level.fluid):
        return _stencil_torch(level, x, b, mode, damp)
    if x.dtype not in _STENCIL_KERNELS:
        raise TypeError(f"stencil kernel takes float32 or bfloat16, got {x.dtype}")
    name, entry = _STENCIL_KERNELS[x.dtype]
    nx, ny, nz = level.fluid.shape
    cell = (nx, ny, nz)
    for arg, t in (("x", x), ("b", b), ("diag", level.diag),
                   ("inv_diag", level.inv_diag), ("fluid", level.fluid)):
        kernels.check(t, x.dtype, cell, arg)
    kernels.check(level.couple_u, x.dtype, (nx + 1, ny, nz), "couple_u")
    kernels.check(level.couple_v, x.dtype, (nx, ny + 1, nz), "couple_v")
    kernels.check(level.couple_w, x.dtype, (nx, ny, nz + 1), "couple_w")
    out = torch.empty_like(x)
    kernels.launch(
        name, entry, x, b, level.diag, level.inv_diag, level.fluid,
        level.couple_u, level.couple_v, level.couple_w, out, nx, ny, nz,
        mode, float(damp), float(level.scale),
    )
    return out


def apply_level(level: MGLevel, p: torch.Tensor) -> torch.Tensor:
    """A_l p."""
    return stencil(level, p, p, MODE_APPLY)


def residual(level: MGLevel, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(b - A x) * fluid."""
    return stencil(level, x, b, MODE_RESIDUAL) * level.fluid


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

# The instances of the fused kernels: dtype -> the prefix of their launch
# names and C entry points ("mg_pre", "lf_mg_pre"; "mg16_pre", ...).
_VCYCLE = {torch.float32: "mg", torch.bfloat16: "mg16"}

# A level of at most this many cells, and every level below it, runs inside
# the one-block kernel "mg_coarse"; the larger levels above take "mg_pre",
# "mg_restrict" and "mg_up", one launch each ("mg16_*" in bfloat16). The
# last level is always coarse; "mg_coarse" keeps its levels in shared memory
# where they fit (:func:`coarse_route`), else sweeps them out of device
# memory with one block, and a level above _COARSE_CELLS_MAX cells is
# refused (a hierarchy that ends so large: a thin slab, or more than
# _MAX_LEVELS halvings to go).
_COARSE_CELLS = 16 * 16 * 16
_COARSE_CELLS_MAX = 32 * 32 * 32
# the shared memory one block may take on the H100 (227 KB)
_BLOCK_SMEM_MAX = 232448


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


def _dtype(levels: Sequence[MGLevel]) -> torch.dtype:
    """The hierarchy's dtype, which the fused kernels have an instance of."""
    dtype = levels[0].fluid.dtype
    if dtype not in _VCYCLE:
        raise TypeError(f"the fused V-cycle kernels take float32 or bfloat16, got {dtype}")
    return dtype


def _check_level(level: MGLevel, name: str = "level", dtype=None) -> Tuple[int, int, int]:
    """Raise unless the level's arrays are what the fused kernels of `dtype`
    (by default the level's own) take."""
    dtype = dtype or _dtype([level])
    nx, ny, nz = cell = tuple(level.fluid.shape)
    if nx * ny * nz >= 1 << 30:
        raise ValueError(f"{name}: {cell} cells, the fused kernels index with 32 bits")
    for arg, t in (("diag", level.diag), ("inv_diag", level.inv_diag), ("fluid", level.fluid)):
        kernels.check(t, dtype, cell, f"{name}.{arg}")
    kernels.check(level.couple_u, dtype, (nx + 1, ny, nz), f"{name}.couple_u")
    kernels.check(level.couple_v, dtype, (nx, ny + 1, nz), f"{name}.couple_v")
    kernels.check(level.couple_w, dtype, (nx, ny, nz + 1), f"{name}.couple_w")
    return cell


def _check_hierarchy(levels: Tuple[MGLevel, ...]) -> None:
    """Raise unless every level is what the fused kernels take, all in one
    dtype, and each is the 2x coarsening of the one above. A
    :class:`Hierarchy` is checked once."""
    if getattr(levels, "fused_checked", False):
        return
    if (_PRE_SMOOTH, _POST_SMOOTH) != (2, 2):
        raise RuntimeError("the fused V-cycle kernels are written for 2 pre- and 2 post-sweeps")
    dtype = _dtype(levels)
    cells = [_check_level(lev, f"level {i}", dtype) for i, lev in enumerate(levels)]
    for fine, coarse in zip(cells, cells[1:]):
        if coarse != _coarse_shape(fine):
            raise ValueError(f"level {coarse} is not the 2x coarsening of {fine}")
    if isinstance(levels, Hierarchy):
        levels.fused_checked = True


def bottom_route(cells: Sequence[int], l: int) -> str:
    """How the bottom of the cycle, from level `l` of a hierarchy whose
    levels hold `cells` cells, runs on CUDA tensors: "block" is the
    one-block kernel "mg_coarse" ("mg16_coarse") on levels `l` and below;
    "sweeps" is the last level alone, too large for one block, as
    ``_COARSE_ITERS`` "stencil" ("stencil16") launches."""
    if l == len(cells) - 1 and cells[l] > _COARSE_CELLS_MAX:
        return "sweeps"
    return "block"


def coarse_smem_bytes(cells: Sequence[int], dtype: torch.dtype) -> int:
    """The shared memory "mg_coarse" ("mg16_coarse") takes to keep levels of
    `cells` cells resident: a cell's inv_diag, b and two x buffers in the
    storage type, and a 16-bit word of its masks (fluid, six faces, diag)."""
    return sum(cells) * (4 * dtype.itemsize + 2)


def coarse_route(cells: Sequence[int], dtype: torch.dtype) -> str:
    """Where "mg_coarse" runs the levels of `cells` cells (its sub-cycle,
    finest first) in `dtype`: "shared", every level in the block's shared
    memory for the whole cycle, where :func:`coarse_smem_bytes` fits one
    block; else "device", the levels and their scratch in device memory
    (only a last level of many cells: a thin slab). Either is a route of the
    kernel; nothing falls back to the plain cycle. Route "shared" keeps the
    masks as bits: it takes the 0/1 couplings and fluid and the integer
    diagonal that :func:`build_levels` makes."""
    return "shared" if coarse_smem_bytes(cells, dtype) <= _BLOCK_SMEM_MAX else "device"


def _check_coarse(sub: Tuple[MGLevel, ...]) -> None:
    """Raise unless the one-block kernel takes these levels."""
    if len(sub) > _MAX_LEVELS:
        raise ValueError(f"mg_coarse takes at most {_MAX_LEVELS} levels, got {len(sub)}")
    cells = tuple(sub[0].fluid.shape)
    if sub[0].fluid.numel() > _COARSE_CELLS_MAX:
        raise ValueError(f"mg_coarse takes levels of at most {_COARSE_CELLS_MAX} cells, got {cells}: "
                         "too large for one block, and not the hierarchy's last level")


def _level_args(level: MGLevel):
    return (level.diag, level.inv_diag, level.fluid, level.couple_u, level.couple_v,
            level.couple_w)


# The launchers: arguments already checked, outputs allocated here; the
# kernels' instance is b's dtype.


def _launch(stage: str, dtype: torch.dtype, *args) -> None:
    prefix = _VCYCLE[dtype]
    kernels.launch(f"{prefix}_{stage}", f"lf_{prefix}_{stage}", *args)


def _launch_pre(level: MGLevel, b: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(b)
    damp = _weak(_SMOOTH_DAMP, b.dtype)
    _launch("pre", b.dtype, b, *_level_args(level), out, *b.shape, damp, level.scale)
    return out


def _launch_restrict(level: MGLevel, level_c: MGLevel, x, b) -> torch.Tensor:
    rc = torch.empty_like(level_c.fluid)
    _launch("restrict", b.dtype, x, b, *_level_args(level), level_c.fluid, rc, *b.shape,
            level.scale)
    return rc


def _launch_up(level: MGLevel, x, ec, b) -> torch.Tensor:
    out = torch.empty_like(b)
    damp = _weak(_SMOOTH_DAMP, b.dtype)
    _launch("up", b.dtype, x, ec, b, *_level_args(level), out, *b.shape, damp, level.scale)
    return out


def _launch_coarse(levels: Tuple[MGLevel, ...], b: torch.Tensor, l: int) -> torch.Tensor:
    if bottom_route([lev.fluid.numel() for lev in levels], l) == "sweeps":
        return _smooth(levels[l], torch.zeros_like(b), b, _COARSE_ITERS)
    sub = levels[l:]
    _check_coarse(sub)
    sizes = [lev.fluid.numel() for lev in sub]
    smem, scratch = 0, None
    if coarse_route(sizes, b.dtype) == "shared":
        smem = coarse_smem_bytes(sizes, b.dtype)
    else:  # xa and xb of every level, and the right-hand sides below the first
        scratch = torch.empty(3 * sum(sizes) - sizes[0], dtype=b.dtype, device=b.device)
    out = torch.empty_like(b)
    arrays = (ctypes.c_void_p * (6 * len(sub)))(
        *(t.data_ptr() for lev in sub for t in _level_args(lev)))
    dims = (ctypes.c_int * (3 * len(sub)))(*(n for lev in sub for n in lev.fluid.shape))
    scales = (ctypes.c_float * len(sub))(*(lev.scale for lev in sub))
    _launch("coarse", b.dtype, b, arrays, dims, scales, len(sub), scratch, out, _PRE_SMOOTH,
            _POST_SMOOTH, _COARSE_ITERS, _weak(_SMOOTH_DAMP, b.dtype), smem)
    return out


def pre_smooth(level: MGLevel, b: torch.Tensor) -> torch.Tensor:
    """Down leg, first half: the pre-sweeps from x = 0, masked
    (``_smooth(level, 0, b, _PRE_SMOOTH)`` of the JAX package). CUDA:
    "mg_pre" ("mg16_pre" in bfloat16) of ``csrc/vcycle.cu``; CPU:
    :func:`_pre_torch`."""
    if not kernels.use_kernel(b, level.fluid):
        return _pre_torch(level, b)
    _check_hierarchy((level,))
    kernels.check(b, level.fluid.dtype, level.fluid.shape, "b")
    return _launch_pre(level, b)


def restrict_residual(level: MGLevel, level_c: MGLevel, x: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Down leg, second half: ``_restrict(level_c, residual(level, x, b))``
    of the JAX package, the residual kept on the chip. CUDA: "mg_restrict"
    ("mg16_restrict"); CPU: :func:`_restrict_residual_torch`."""
    if not kernels.use_kernel(x, b, level.fluid, level_c.fluid):
        return _restrict_residual_torch(level, level_c, x, b)
    _check_hierarchy((level, level_c))
    kernels.check(x, level.fluid.dtype, level.fluid.shape, "x")
    kernels.check(b, level.fluid.dtype, level.fluid.shape, "b")
    return _launch_restrict(level, level_c, x, b)


def prolong_smooth(level: MGLevel, x: torch.Tensor, ec: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Up leg: ``_smooth(level, x + _prolong(ec) * fluid, b, _POST_SMOOTH)``
    of the JAX package. CUDA: "mg_up" ("mg16_up"); CPU: :func:`_up_torch`."""
    if not kernels.use_kernel(x, ec, b, level.fluid):
        return _up_torch(level, x, ec, b)
    _check_hierarchy((level,))
    dtype = level.fluid.dtype
    kernels.check(x, dtype, level.fluid.shape, "x")
    kernels.check(b, dtype, level.fluid.shape, "b")
    kernels.check(ec, dtype, _coarse_shape(level.fluid.shape), "ec")
    return _launch_up(level, x, ec, b)


def coarse_cycle(levels: Tuple[MGLevel, ...], b: torch.Tensor, l: int) -> torch.Tensor:
    """``v_cycle(levels, b, l)`` of the JAX package for the small levels:
    the whole sub-cycle from level `l` down, the coarsest level's sweeps
    included. CUDA: "mg_coarse" ("mg16_coarse"), one launch of one block
    with the levels in its shared memory or, where they do not fit, in
    device memory (:func:`coarse_route`), or, for a last level too large for
    one block, its sweeps as "stencil" ("stencil16") launches
    (:func:`bottom_route`); CPU: :func:`_coarse_torch`."""
    if not kernels.use_kernel(b, *(lev.fluid for lev in levels[l:])):
        return _coarse_torch(levels, b, l)
    _check_hierarchy(levels)
    kernels.check(b, levels[l].fluid.dtype, levels[l].fluid.shape, "b")
    return _launch_coarse(levels, b, l)


def first_coarse_level(levels: Tuple[MGLevel, ...]) -> int:
    """The first level that :func:`coarse_cycle` takes."""
    for l, lev in enumerate(levels):
        if lev.fluid.numel() <= _COARSE_CELLS:
            return l
    return len(levels) - 1


def v_cycle(levels: Tuple[MGLevel, ...], b: torch.Tensor, l: int = 0) -> torch.Tensor:
    """One V-cycle from x = 0: the preconditioner M^-1 b up to the operator
    scale (port of ``multigrid.v_cycle``).

    The cycle, in float32 or in the bfloat16 of "mg16" (the hierarchy's
    dtype), is composed of the four stages :func:`pre_smooth`,
    :func:`restrict_residual`, :func:`coarse_cycle` and
    :func:`prolong_smooth`: on CUDA tensors these are the fused kernels of
    ``csrc/vcycle.cu`` ("mg_*", "mg16_*") and nothing runs between them but
    the allocation of their outputs (3 launches per large level and 1 for
    the small levels; a last level above ``_COARSE_CELLS_MAX`` cells takes
    "stencil" or "stencil16" launches instead, :func:`bottom_route`); on
    CPU tensors, their plain versions. A hierarchy the kernels do not take
    raises; nothing falls back to :func:`v_cycle_per_pass`.
    """
    coarse = max(l, first_coarse_level(levels))
    if kernels.use_kernel(b, levels[l].fluid):
        # the hierarchy is checked once; below, the kernels' own outputs
        _check_hierarchy(levels)
        kernels.check(b, levels[l].fluid.dtype, levels[l].fluid.shape, "b")
        pre, down, up, bottom = _launch_pre, _launch_restrict, _launch_up, _launch_coarse
    else:
        pre, down, up, bottom = _pre_torch, _restrict_residual_torch, _up_torch, _coarse_torch
    xs, bs = [], [b]
    for m in range(l, coarse):
        xs.append(pre(levels[m], bs[-1]))
        bs.append(down(levels[m], levels[m + 1], xs[-1], bs[-1]))
    e = bottom(levels, bs.pop(), coarse)
    for m in reversed(range(l, coarse)):
        e = up(levels[m], xs.pop(), e, bs.pop())
    return e
