"""Geometric multigrid preconditioner for the pressure Poisson solve (port of
``libfluid_tpu.sim.multigrid``).

A matrix-free V-cycle: 2x coarsening with cell-type rediscretization,
damped-Jacobi smoothing, cell-centred trilinear prolongation P and its exact
transpose R = P^T / 8 as restriction, per-level operator scale 4^-l. Every
apply, smoothing sweep and residual is one pass of the masked 7-point
stencil (:func:`stencil`, kernel C), on every level, in float32 or, for the
"mg16" preconditioner, in bfloat16.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from libfluid_tpu_torch.config import CellType
from libfluid_tpu_torch.grids import pad1
from libfluid_tpu_torch.sim import kernels

_SMOOTH_DAMP = 0.8  # damped-Jacobi weight
_PRE_SMOOTH = 2
_POST_SMOOTH = 2
_COARSE_ITERS = 12  # Jacobi iterations on the coarsest level
_MIN_SIZE = 8  # stop coarsening at <= this many cells per axis

# stencil modes (csrc/stencil.cu)
MODE_APPLY, MODE_JACOBI, MODE_RESIDUAL = 0, 1, 2


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


def build_levels(cell_type: torch.Tensor, dtype=torch.float32) -> Tuple[MGLevel, ...]:
    levels: List[MGLevel] = []
    ct = cell_type
    scale = 1.0
    while True:
        levels.append(_operator_from_types(ct, scale, dtype))
        if min(ct.shape) <= _MIN_SIZE or len(levels) >= 6:
            break
        ct = _coarsen_types(ct)
        scale *= 0.25
    return tuple(levels)


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
    weight is taken as the bfloat16 value nearest to `damp`, as the JAX
    package's weakly typed scalar is.
    """
    if x.dtype == torch.bfloat16:
        damp = float(torch.tensor(damp, dtype=torch.bfloat16))
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


def v_cycle(levels: Tuple[MGLevel, ...], b: torch.Tensor, l: int = 0) -> torch.Tensor:
    level = levels[l]
    if l == len(levels) - 1:
        return _smooth(level, torch.zeros_like(b), b, _COARSE_ITERS)
    x = _smooth(level, torch.zeros_like(b), b, _PRE_SMOOTH)
    r = residual(level, x, b)
    rc = _restrict(levels[l + 1], r)
    ec = v_cycle(levels, rc, l + 1)
    x = x + _prolong(ec, b.shape) * level.fluid
    x = _smooth(level, x, b, _POST_SMOOTH)
    return x
