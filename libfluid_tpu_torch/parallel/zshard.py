"""Explicit z-sharded simulation substep (port of
``libfluid_tpu.parallel.zshard``).

The JAX package runs the whole substep inside one ``shard_map``; here every
rank runs :func:`substep_z` on its own share, and the only communication is
what the physics needs, as there:

- particle exchange after advection: a fixed-capacity ±1 ring
  (:func:`_exchange_particles`, CFL-bounded motion < one slab);
- one ghost slot-layer exchange feeding P2G (kernel B) and the correction
  springs (kernel E) on the z-extended tile;
- width-1 halo exchanges inside the pressure MG-PCG, ``all_reduce`` dot
  products and residual; levels below ``_REPLICATE_Z`` layers are gathered
  and run the dense V-cycle (the fused kernels on the card);
- one ghost face-layer exchange feeding G2P (kernel D).

Rank-local state (what :func:`zshard_state` returns and :func:`substep_z`
takes): the particle rows of the rank's z-slab (``nl`` rows, padded with
inactive ones), the grid's z-tile, ``u`` (nx+1, ny, nzl), ``v`` (nx, ny+1,
nzl), ``w`` (nx, ny, nzl+1) with the tile's top face (the next tile's
bottom face; both compute it), ``cell_type`` and ``pressure`` (nx, ny,
nzl); ``solid``, the sources, the generator and the time whole on every
rank. Rank d owns cells z in [d*nzl, (d+1)*nzl). :func:`gather_state`, which
the JAX package does not need (its sharded arrays are global), reassembles
the global state on every rank; its particle rows are the ranks' rows in
rank order, as the JAX package's global array holds them.

Positions stay in world coordinates: a tile's config carries the world
offset of its first layer (kernels B, D and E take it), where the JAX
package shifts each tile's positions into a frame of its own and the ghost
layers' into it. Kernel E's spring sum rounds with the size of the
coordinates, so the dense path's coordinates give its springs bit for bit.

Random draws come from a :class:`~libfluid_tpu_torch.sim.step.Draws` as in
the dense substep; every rank holds the same generator state, so every rank
draws the same numbers. A source cell is seeded by the rank that owns it
with the dense substep's candidate offsets (the JAX package folds the rank
into its key).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from libfluid_tpu_torch import grids
from libfluid_tpu_torch.config import CellType, SimConfig, TransferScheme
from libfluid_tpu_torch.parallel import halo
from libfluid_tpu_torch.parallel.mesh import RankMesh
from libfluid_tpu_torch.sim import binning as binning_mod
from libfluid_tpu_torch.sim import collisions as collisions_mod
from libfluid_tpu_torch.sim import correction as correction_mod
from libfluid_tpu_torch.sim import multigrid
from libfluid_tpu_torch.sim import pressure as pressure_mod
from libfluid_tpu_torch.sim import slots as slots_mod
from libfluid_tpu_torch.sim import sources as sources_mod
from libfluid_tpu_torch.sim import transfers
from libfluid_tpu_torch.sim.state import SimState
from libfluid_tpu_torch.sim.step import Diagnostics, Draws, _advect, _collide

# ---------------------------------------------------------------------------
# Halo exchange primitives (z minor axis)
# ---------------------------------------------------------------------------


def ghosts_z(x: torch.Tensor, mesh: RankMesh, fill=0.0, width: int = 1):
    """(ghost_lo, ghost_hi) layers of a local (..., nzl) tile from the z
    neighbours; the domain ends read `fill`. Each ghost is (..., width)."""
    from_below, from_above = halo.ring(x[..., -width:], x[..., :width], mesh)
    lo = torch.full_like(from_below, fill) if mesh.rank == 0 else from_below
    hi = torch.full_like(from_above, fill) if mesh.rank == mesh.size - 1 else from_above
    return lo, hi


def pad_z(x: torch.Tensor, mesh: RankMesh, fill=0.0, width: int = 1) -> torch.Tensor:
    """Local tile extended with `width` ghost layers on each z side."""
    lo, hi = ghosts_z(x, mesh, fill, width)
    return torch.cat([lo, x, hi], dim=-1)


def _pad_xy(x: torch.Tensor, value) -> torch.Tensor:
    """One layer of `value` on both sides of the first two axes."""
    out = torch.full((x.shape[0] + 2, x.shape[1] + 2, *x.shape[2:]), value, dtype=x.dtype, device=x.device)
    out[1:-1, 1:-1] = x
    return out


# ---------------------------------------------------------------------------
# Sharded multigrid-preconditioned CG (pressure)
# ---------------------------------------------------------------------------

# Levels with a global z below this run replicated (one all_gather, then
# the dense V-cycle): the coarse smoother would otherwise cost a halo
# exchange a sweep for little work.
_REPLICATE_Z = 16


class ZLevel(NamedTuple):
    """One z-sharded multigrid level (local tiles; cf. ``multigrid.MGLevel``)."""

    fluid: torch.Tensor  # (nx, ny, nzl)
    diag: torch.Tensor
    inv_diag: torch.Tensor
    couple_u: torch.Tensor  # (nx+1, ny, nzl)
    couple_v: torch.Tensor  # (nx, ny+1, nzl)
    couple_w_lo: torch.Tensor  # (nx, ny, nzl): the cell couples to its -z neighbour
    couple_w_hi: torch.Tensor  # (nx, ny, nzl): ... to its +z neighbour
    scale: float


def _zlevel_from_types(ct_local: torch.Tensor, scale: float, dtype, mesh: RankMesh) -> ZLevel:
    """A level's masks from the local cell types and one ghost type layer:
    the discretization of ``multigrid._operator_from_types``."""
    cte = pad_z(ct_local, mesh, fill=CellType.SOLID)  # (nx, ny, nzl+2)
    solid = cte == CellType.SOLID
    fluid_b = cte == CellType.FLUID
    sp = _pad_xy(solid, True)
    nonsolid = (
        (~sp[:-2, 1:-1, 1:-1]).to(dtype)
        + (~sp[2:, 1:-1, 1:-1]).to(dtype)
        + (~sp[1:-1, :-2, 1:-1]).to(dtype)
        + (~sp[1:-1, 2:, 1:-1]).to(dtype)
        + (~solid[:, :, :-2]).to(dtype)
        + (~solid[:, :, 2:]).to(dtype)
    )
    fp = _pad_xy(fluid_b, False)
    cu = (fp[:-1, 1:-1, 1:-1] & fp[1:, 1:-1, 1:-1]).to(dtype)
    cv = (fp[1:-1, :-1, 1:-1] & fp[1:-1, 1:, 1:-1]).to(dtype)
    f_in = fluid_b[:, :, 1:-1]
    cw_lo = (f_in & fluid_b[:, :, :-2]).to(dtype)
    cw_hi = (f_in & fluid_b[:, :, 2:]).to(dtype)
    fluid = f_in.to(dtype)
    diag = nonsolid * fluid
    inv_diag = torch.where(diag > 0, 1.0 / torch.clamp(diag * scale, min=1e-30), torch.zeros_like(diag))
    return ZLevel(fluid, diag, inv_diag, cu, cv, cw_lo, cw_hi, scale)


def _apply_zlevel(level: ZLevel, p: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """A_l p on a local tile: one halo exchange for the z-neighbour terms."""
    return halo.sharded_apply_A(level.fluid, level.couple_w_lo, level.couple_w_hi, level.couple_u,
                                level.couple_v, level.diag, p, level.scale, mesh)


def _smooth_z(level: ZLevel, x, b, iters: int, mesh: RankMesh):
    for _ in range(iters):
        r = b - _apply_zlevel(level, x, mesh)
        x = x + multigrid._SMOOTH_DAMP * level.inv_diag * r
    return x * level.fluid


def _block_sum(r: torch.Tensor) -> torch.Tensor:
    """0.125 x the sum of each 2x2x2 block (x and y zero-padded when odd;
    the z tile sizes stay even down to the replicated levels)."""
    nx, ny, nz = r.shape
    px, py = nx % 2, ny % 2
    if px or py:
        r = torch.nn.functional.pad(r, (0, 0, 0, py, 0, px))
    c = r.reshape(r.shape[0] // 2, 2, r.shape[1] // 2, 2, nz // 2, 2)
    return c.sum(dim=(1, 3, 5)) * 0.125


def _restrict_z(level_c: ZLevel, r: torch.Tensor) -> torch.Tensor:
    """Local 2x restriction, masked to the coarse fluid cells."""
    return _block_sum(r) * level_c.fluid


def _prolong_z(e_c: torch.Tensor, fine_shape) -> torch.Tensor:
    e = e_c.repeat_interleave(2, 0).repeat_interleave(2, 1).repeat_interleave(2, 2)
    return e[: fine_shape[0], : fine_shape[1], :]


class ZLevels(NamedTuple):
    """The preconditioner: sharded fine levels and the replicated coarse
    tail (``multigrid.MGLevel``s, the same on every rank) once the global z
    size drops below ``_REPLICATE_Z``."""

    sharded: Tuple[ZLevel, ...]
    dense: Tuple[multigrid.MGLevel, ...]


def build_zlevels(ct_local: torch.Tensor, nz_global: int, dtype, mesh: RankMesh) -> ZLevels:
    """Mirror of ``multigrid.build_levels``: the same stopping rule and
    coarsening, split into sharded and replicated by global z extent."""
    n_dev = nz_global // ct_local.shape[2]
    sharded, dense = [], []
    ct = ct_local
    scale = 1.0
    nlev = 0
    gathered = False
    while True:
        gx, gy = ct.shape[0], ct.shape[1]
        gz = ct.shape[2] * (1 if gathered else n_dev)
        if not gathered and (gz < _REPLICATE_Z or ct.shape[2] % 2 != 0):
            ct = halo.all_gather(ct, mesh, dim=2)
            gathered = True
            gz = ct.shape[2]
        if gathered:
            dense.append(multigrid._operator_from_types(ct, scale, dtype))
        else:
            sharded.append(_zlevel_from_types(ct, scale, dtype, mesh))
        nlev += 1
        if min(gx, gy, gz) <= multigrid._MIN_SIZE or nlev >= multigrid._MAX_LEVELS:
            break
        ct = multigrid._coarsen_types(ct)
        scale *= 0.25
    return ZLevels(tuple(sharded), multigrid.Hierarchy(dense))


def _v_cycle_z(levels: ZLevels, b: torch.Tensor, mesh: RankMesh, l: int = 0) -> torch.Tensor:
    ns = len(levels.sharded)
    if l >= ns:
        # replicated tail: gather the right-hand side once, run the dense
        # V-cycle on every rank, keep the local part
        bg = halo.all_gather(b, mesh, dim=2)
        eg = multigrid.v_cycle(levels.dense, bg, l - ns)
        nzl = b.shape[2]
        return eg[:, :, mesh.rank * nzl : (mesh.rank + 1) * nzl]
    level = levels.sharded[l]
    if l == ns - 1 and not levels.dense:
        return _smooth_z(level, torch.zeros_like(b), b, multigrid._COARSE_ITERS, mesh)
    x = _smooth_z(level, torch.zeros_like(b), b, multigrid._PRE_SMOOTH, mesh)
    r = (b - _apply_zlevel(level, x, mesh)) * level.fluid
    if l + 1 < ns:
        rc = _restrict_z(levels.sharded[l + 1], r)
    else:
        # the next level is replicated: restrict without the coarse mask
        # (inv_diag is zero outside fluid, so the dense cycle ignores it)
        rc = _block_sum(r)
    ec = _v_cycle_z(levels, rc, mesh, l + 1)
    x = x + _prolong_z(ec, b.shape) * level.fluid
    return _smooth_z(level, x, b, multigrid._POST_SMOOTH, mesh)


def _zdot(a, b, mesh: RankMesh):
    return halo.sharded_dot(a, b, mesh)


def _cg_z(levels: ZLevels, b, a_scale, tol, max_iters, precond, mesh: RankMesh, x0=None):
    """Sharded mirror of ``pressure._cg``: ``all_reduce`` dots and residual;
    the loop reads the (global) residual on the host once an iteration."""
    if not levels.sharded:
        # the whole grid replicated (a short z): the dense CG on every rank
        bg = halo.all_gather(b, mesh, dim=2)
        x0g = None if x0 is None else halo.all_gather(x0, mesh, dim=2)
        res = pressure_mod._cg(levels.dense, bg, a_scale, tol, max_iters, precond, x0=x0g)
        nzl = b.shape[2]
        return res._replace(pressure=res.pressure[:, :, mesh.rank * nzl : (mesh.rank + 1) * nzl])
    lvl0 = levels.sharded[0]

    if precond == "mg16":
        levels16 = ZLevels(
            sharded=tuple(ZLevel(*[f.to(torch.bfloat16) for f in lev[:-1]], lev.scale) for lev in levels.sharded),
            dense=multigrid.Hierarchy(
                multigrid.MGLevel(*[f.to(torch.bfloat16) for f in lev[:-1]], lev.scale) for lev in levels.dense
            ),
        )

    def apply_M(r):
        if precond == "mg16":
            return _v_cycle_z(levels16, r.to(torch.bfloat16), mesh).to(r.dtype) / a_scale
        if precond == "mg":
            return _v_cycle_z(levels, r, mesh) / a_scale
        return lvl0.inv_diag / a_scale * r

    def apply_A1(p):
        return _apply_zlevel(lvl0, p, mesh) * a_scale

    nontrivial = bool(_zdot(b, b, mesh) >= 1e-6)
    if x0 is None:
        p = torch.zeros_like(b)
        r = b
    else:
        # the early-out returns the cold start's zero pressure, not x0
        p = x0 * lvl0.fluid if nontrivial else torch.zeros_like(b)
        r = b - apply_A1(p)
    z = apply_M(r)
    s = z
    sigma = _zdot(z, r, mesh)
    res = halo.all_max(torch.amax(torch.abs(r)), mesh)
    if not nontrivial:
        res = torch.zeros_like(res)

    it = 0
    while nontrivial and it < max_iters and bool(res >= tol):
        z = apply_A1(s)
        alpha = sigma / pressure_mod._safe(_zdot(z, s, mesh))
        p = p + alpha * s
        r = r - alpha * z
        res = halo.all_max(torch.amax(torch.abs(r)), mesh)
        z = apply_M(r)
        sigma_new = _zdot(z, r, mesh)
        beta = sigma_new / pressure_mod._safe(sigma)
        s = z + beta * s
        sigma = sigma_new
        it += 1
    return pressure_mod.PressureResult(
        pressure=p * lvl0.fluid, residual=res,
        iterations=torch.tensor(it, dtype=torch.int32, device=b.device),
    )


# ---------------------------------------------------------------------------
# Local grid stages (right-hand side, apply_pressure, extrapolation)
# ---------------------------------------------------------------------------


class LocalGrid(NamedTuple):
    """A tile's face arrays. w holds its nzl+1 local faces (the top face is
    the next tile's bottom face; both tiles compute it the same way)."""

    u: torch.Tensor  # (nx+1, ny, nzl)
    v: torch.Tensor  # (nx, ny+1, nzl)
    w: torch.Tensor  # (nx, ny, nzl+1)
    cell_type: torch.Tensor  # (nx, ny, nzl) int8


def _open_face_masks_local(ct_local, dtype, mesh: RankMesh):
    """Faces whose two cells (out of the domain = solid) are non-solid; z
    needs the ghost type layers."""
    solid = pad_z(ct_local, mesh, fill=CellType.SOLID) == CellType.SOLID
    sp = _pad_xy(solid, True)
    open_u = (~sp[:-1, 1:-1, 1:-1] & ~sp[1:, 1:-1, 1:-1]).to(dtype)
    open_v = (~sp[1:-1, :-1, 1:-1] & ~sp[1:-1, 1:, 1:-1]).to(dtype)
    open_w = (~solid[:, :, :-1] & ~solid[:, :, 1:]).to(dtype)  # nzl+1 faces
    return open_u, open_v, open_w


def _rhs_local(g: LocalGrid, cfg: SimConfig, mesh: RankMesh) -> torch.Tensor:
    open_u, open_v, open_w = _open_face_masks_local(g.cell_type, cfg.dtype, mesh)
    ue = g.u * open_u
    ve = g.v * open_v
    we = g.w * open_w
    div = (ue[1:] - ue[:-1]) + (ve[:, 1:] - ve[:, :-1]) + (we[:, :, 1:] - we[:, :, :-1])
    fluid = (g.cell_type == CellType.FLUID).to(cfg.dtype)
    return -div / cfg.cell_size * fluid


def _apply_pressure_local(g: LocalGrid, p: torch.Tensor, cfg: SimConfig, dt, mesh: RankMesh) -> LocalGrid:
    """``pressure.apply_pressure`` on a tile: one ghost layer of pressure and
    of cell types covers the z-face updates (the shared top face too)."""
    coeff = dt / (cfg.density * cfg.cell_size)
    ct = g.cell_type
    fluid_local = (ct == CellType.FLUID).to(torch.int8)
    fe = pad_z(fluid_local, mesh, fill=0) > 0  # (nx, ny, nzl+2)
    pe = pad_z(p * fluid_local.to(p.dtype), mesh, fill=0.0)
    open_u, open_v, open_w = _open_face_masks_local(ct, cfg.dtype, mesh)
    fp = _pad_xy(fe, False)
    pp = _pad_xy(pe, 0.0)

    def upd(face_vel, p_l, p_r, f_l, f_r, open_m):
        touched = f_l | f_r
        updated = face_vel - coeff * (p_r - p_l)
        new_vel = torch.where(open_m > 0, updated, torch.zeros_like(updated))
        return torch.where(touched, new_vel, face_vel)

    u = upd(g.u, pp[:-1, 1:-1, 1:-1], pp[1:, 1:-1, 1:-1], fp[:-1, 1:-1, 1:-1], fp[1:, 1:-1, 1:-1], open_u)
    v = upd(g.v, pp[1:-1, :-1, 1:-1], pp[1:-1, 1:, 1:-1], fp[1:-1, :-1, 1:-1], fp[1:-1, 1:, 1:-1], open_v)
    w = upd(g.w, pe[:, :, :-1], pe[:, :, 1:], fe[:, :, :-1], fe[:, :, 1:], open_w)
    return g._replace(u=u, v=v, w=w)


def _extrapolate_local(g: LocalGrid, cfg: SimConfig, mesh: RankMesh) -> LocalGrid:
    """``extrapolation.extrapolate`` on a tile: ghost (velocity, valid)
    layers every sweep, ghost types once (SOLID past the domain ends)."""
    iters = cfg.velocity_extrapolation_iterations
    if iters <= 0:
        return g
    ct = g.cell_type
    cte = pad_z(ct, mesh, fill=CellType.SOLID)  # (nx, ny, nzl+2)
    vel = torch.stack([g.u[1:], g.v[:, 1:], g.w[:, :, 1:]], dim=-1)
    valid = (ct == CellType.FLUID).to(cfg.dtype)

    def nsum_ext(xe):
        """Sum of the 6 neighbours of a z-extended input, cropped to the tile."""
        xp = _pad_xy(xe, 0)
        return (
            xp[:-2, 1:-1, 1:-1] + xp[2:, 1:-1, 1:-1] + xp[1:-1, :-2, 1:-1]
            + xp[1:-1, 2:, 1:-1] + xp[1:-1, 1:-1, :-2] + xp[1:-1, 1:-1, 2:]
        )

    def shift_neg_ext(xe, axis, fill):
        """The +axis neighbour of a z-extended input, cropped to the tile."""
        if axis == 2:
            return xe[:, :, 2:]
        out = torch.full_like(xe, fill)
        if axis == 0:
            out[:-1] = xe[1:]
        else:
            out[:, :-1] = xe[:, 1:]
        return out[:, :, 1:-1]

    nb_type = [shift_neg_ext(cte, dim, CellType.SOLID) == ct for dim in range(3)]
    for _ in range(iters):
        ve = pad_z(vel.movedim(2, -1), mesh).movedim(-1, 2)
        va = pad_z(valid, mesh)
        nsum = nsum_ext(ve * va[..., None])
        ncount = nsum_ext(va)
        has = ncount > 0
        avg = nsum / torch.clamp(ncount, min=1.0)[..., None]
        newly = (valid == 0) & has
        write = torch.stack(
            [newly & (shift_neg_ext(va, dim, 0.0) > 0) & nb_type[dim] for dim in range(3)], dim=-1
        )
        vel = torch.where(write, avg, vel)
        valid = torch.where(newly, torch.ones_like(valid), valid)
    u, v, w = g.u.clone(), g.v.clone(), g.w.clone()
    u[1:] = vel[..., 0]
    v[:, 1:] = vel[..., 1]
    w[:, :, 1:] = vel[..., 2]
    # a tile writes its faces 1..nzl (each cell's +z face); its face 0 is the
    # rank below's face nzl, which that rank wrote. The JAX package keeps
    # the tile's own unextrapolated copy there (it differs from the dense
    # substep where the cell below the seam was extrapolated into)
    below, _ = ghosts_z(w[:, :, -1:], mesh)
    if mesh.rank > 0:
        w[:, :, :1] = below
    return g._replace(u=u, v=v, w=w)


# ---------------------------------------------------------------------------
# Particle exchange
# ---------------------------------------------------------------------------


def _first(mask: torch.Tensor, size: int) -> torch.Tensor:
    """The first `size` indices where `mask` holds, padded with len(mask)
    (``jnp.nonzero(mask, size=size, fill_value=n)``)."""
    n = mask.shape[0]
    found = torch.nonzero(mask).reshape(-1)[:size]
    out = torch.full((size,), n, dtype=torch.int64, device=mask.device)
    out[: found.shape[0]] = found
    return out


def _exchange_particles(pos, vel, aff, act, cfg: SimConfig, nzl: int, cap: int, mesh: RankMesh):
    """Re-home particles to the rank owning their z-slab (ring ±1).

    Motion is CFL-bounded under one slab, so |owner - rank| <= 1; a row
    further away, or past a full send buffer of `cap` rows, or without a
    free row on the receiving side, is deactivated and counted. Returns (pos, vel, aff,
    act, lost), lost summed over the ranks."""
    n = pos.shape[0]
    d, ndev = mesh.rank, mesh.size
    zc = torch.clamp(torch.floor((pos[:, 2] - cfg.grid_offset[2]) / cfg.cell_size).to(torch.int32), 0, cfg.nz - 1)
    rel = zc // nzl - d
    payload = torch.cat([pos, vel, aff.reshape(n, 9), act[:, None].to(pos.dtype)], dim=1)  # (N, 16)

    def pack(mask):
        idx = _first(mask, cap)
        ok = idx < n
        buf = payload[torch.clamp(idx, max=n - 1)] * ok[:, None].to(payload.dtype)
        return buf, ok.sum(dtype=torch.int32)

    up_mask = act & (rel == 1)
    dn_mask = act & (rel == -1)
    buf_up, sent_up = pack(up_mask)
    buf_dn, sent_dn = pack(dn_mask)
    lost = (
        up_mask.sum(dtype=torch.int32) - sent_up + dn_mask.sum(dtype=torch.int32) - sent_dn
        + (act & (torch.abs(rel) > 1)).sum(dtype=torch.int32)
    )
    recv_lo, recv_hi = halo.ring(buf_up, buf_dn, mesh)  # from d-1, from d+1
    if d == 0:
        recv_lo = torch.zeros_like(recv_lo)
    if d == ndev - 1:
        recv_hi = torch.zeros_like(recv_hi)
    recv = torch.cat([recv_lo, recv_hi], dim=0)  # (2cap, 16)
    # the arrivals fill the free rows in order (the JAX package writes the
    # rows from above at offset cap of the free rows, so a rank with fewer
    # than cap free rows drops them all)
    arrived = recv[recv[:, 15] > 0.5]

    keep = act & (rel == 0)
    merged = payload * keep[:, None].to(payload.dtype)
    free_idx = _first(~keep, arrived.shape[0])
    fits = free_idx < n
    merged[free_idx[fits]] = arrived[fits]
    dropped = (~fits).sum(dtype=torch.int32)
    lost = halo.all_sum(lost + dropped, mesh)
    return merged[:, 0:3], merged[:, 3:6], merged[:, 6:15].reshape(n, 3, 3), merged[:, 15] > 0.5, lost


# ---------------------------------------------------------------------------
# The sharded substep
# ---------------------------------------------------------------------------


def _local_cfg(cfg: SimConfig, nzl: int, nl: int, z0: int = 0, extra_z: int = 0) -> SimConfig:
    """A tile's config: nzl + extra_z layers from global layer z0, its z
    offset the world z of that layer (rounded as float32 rounds it)."""
    f = np.float32
    oz = float(f(z0) * f(cfg.cell_size) + f(cfg.grid_offset[2]))
    return dataclasses.replace(
        cfg, grid_size=(cfg.nx, cfg.ny, nzl + extra_z), particle_capacity=nl,
        grid_offset=(cfg.grid_offset[0], cfg.grid_offset[1], oz),
    )


def _local_substep(state: SimState, cfg: SimConfig, dt, mesh: RankMesh, draws: Draws):
    """A rank's substep on its share (see the module's text)."""
    ndev, d = mesh.size, mesh.rank
    nzl = cfg.nz // ndev
    nl = state.position.shape[0]
    dev = state.position.device
    dt = torch.as_tensor(dt, dtype=cfg.dtype, device=dev)
    # positions stay in world coordinates: the tile's config, and that of
    # the tile extended by a ghost layer each side, carry its world offset
    cfg_l = _local_cfg(cfg, nzl, nl, z0=d * nzl)
    cfg_e = _local_cfg(cfg, nzl, nl, z0=d * nzl - 1, extra_z=2)

    # --- source coercion, advection and collisions (world coordinates;
    # solid and sources are whole on every rank) ---
    old_pos = state.position
    state = _collide(_advect(state, cfg, dt), old_pos, cfg)

    # --- particle exchange: a send buffer of half the block (the JAX
    # package's size) unless exchange_capacity says otherwise ---
    pos, vel, aff, act, lost = _exchange_particles(
        state.position, state.velocity, state.affine, state.active, cfg, nzl,
        cfg.exchange_capacity or max(64, nl // 2), mesh,
    )

    st_l = state._replace(position=pos, velocity=vel, affine=aff, active=act)

    # --- sources: the owner of a source cell tops it up, with the dense
    # substep's candidate offsets ---
    n_src = state.sources.cells.shape[0]
    if n_src > 0:
        src = state.sources
        owner = src.cells[:, 2] // nzl
        cells = src.cells.clone()
        cells[:, 2] = torch.clamp(cells[:, 2] - d * nzl, 0, nzl - 1)
        src_l = src._replace(cells=cells, active=src.active & (owner == d))
        occ0 = binning_mod.bin_particles(st_l.position, st_l.active, cfg_l).occupancy
        jitter = draws.source_jitter(n_src, cfg)
        st_l = sources_mod.seed_from_jitter(st_l._replace(sources=src_l), occ0, cfg_l, jitter)
        st_l = st_l._replace(sources=src)
    st_l, bins = binning_mod.sort_by_cell(st_l, cfg_l)
    pos, vel, aff, act = st_l.position, st_l.velocity, st_l.affine, st_l.active
    old_pos = pos

    # --- slot grid + ghost slot layers: the passes run on the tile extended
    # by the neighbours' edge layers ---
    slot_grid = slots_mod.build(pos, vel, aff if cfg.scheme == TransferScheme.APIC else None, bins, cfg_l)
    glo, ghi = ghosts_z(slot_grid.data, mesh)  # (16, K, nx, ny, 1) each
    data_ext = torch.cat([glo, slot_grid.data, ghi], dim=-1)  # (16, K, nx, ny, nzl+2)

    # --- P2G on the extended tile (kernel B), then the slot-overflow rows
    # (a neighbour's overflow rows in its edge layer are not exchanged: a
    # crammed cell at a seam degrades as the dense path's past capacity) ---
    faces = transfers.p2g_slots(slot_grid._replace(data=data_ext), pos, vel, aff, act, cfg_e)
    u, v, w = (f[:, :, 1:-1] for f in faces)  # normalizing is elementwise: crop after it

    # --- mark cells ---
    solid_l = state.solid[:, :, d * nzl : (d + 1) * nzl]
    ct = torch.full_like(solid_l, CellType.AIR, dtype=torch.int8)
    ct[(bins.occupancy > 0) & ~solid_l] = CellType.FLUID
    ct[solid_l] = CellType.SOLID
    g = LocalGrid(u=u, v=v, w=w, cell_type=ct)

    old_g = None
    if cfg.scheme == TransferScheme.APIC:
        g = _remove_boundary_normals_local(g, d, ndev)
    elif cfg.scheme == TransferScheme.FLIP:
        old_g = _remove_boundary_normals_local(g, d, ndev)

    # --- gravity (every face but the global min walls) ---
    gvec = torch.tensor(cfg.gravity, dtype=cfg.dtype, device=dev) * dt
    u2, v2 = g.u.clone(), g.v.clone()
    u2[1:] += gvec[0]
    v2[:, 1:] += gvec[1]
    w2 = g.w + gvec[2]
    if d == 0:
        w2[:, :, 0] = g.w[:, :, 0]
    g = g._replace(u=u2, v=v2, w=w2)

    # --- pressure projection (sharded MG-PCG) ---
    levels = build_zlevels(g.cell_type, cfg.nz, cfg.dtype, mesh)
    a_scale = dt / (cfg.density * cfg.cell_size * cfg.cell_size)
    b = _rhs_local(g, cfg, mesh)
    pres = _cg_z(
        levels, b, a_scale, cfg.solver.tolerance, cfg.solver.max_iterations,
        pressure_mod._precond_tag(cfg), mesh, x0=state.pressure,
    )
    g = _apply_pressure_local(g, pres.pressure, cfg, dt, mesh)

    # --- position correction on the extended slot grid (kernel E) ---
    corr_unc = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.enable_position_correction:
        seed = draws.correction_seed()
        kc_l = min(cfg.correction_capacity, slot_grid.capacity)
        corr_unc = torch.clamp(
            (act & (slot_grid.slot_of >= kc_l * cfg_l.num_cells)).sum(dtype=torch.int32)
            - cfg.correction_overflow_capacity, min=0,
        )
        pos = _correct_positions_local(pos, act, slot_grid, data_ext, cfg, cfg_e, dt, seed, z0=d * nzl)
    if cfg.enable_collisions:
        cp = collisions_mod.resolve_collisions(old_pos, pos, state.solid, cfg)
        pos = torch.where(act[:, None], cp, pos)

    # --- velocity extrapolation ---
    g = _extrapolate_local(g, cfg, mesh)

    # --- G2P from the ghost-extended face arrays (kernel D) ---
    grid_e = _extended_faces(g, mesh)
    if cfg.scheme == TransferScheme.FLIP:
        nvel = transfers.g2p_flip(grid_e, _extended_faces(old_g, mesh), pos, vel, cfg_e)
        naff = aff
    else:
        nvel, naff = transfers.g2p_pic(grid_e, pos, cfg_e)
        if cfg.scheme == TransferScheme.PIC:
            naff = aff
    nvel = torch.where(act[:, None], nvel, vel)
    naff = torch.where(act[:, None, None], naff, aff)

    # --- diagnostics (global reductions) ---
    active_f = act.to(cfg.dtype)
    vsq = torch.sum(nvel**2, dim=-1) * active_f
    gv = torch.tensor(cfg.gravity, dtype=cfg.dtype, device=dev)
    diag = Diagnostics(
        kinetic_energy=halo.all_sum(0.5 * torch.sum(vsq), mesh),
        potential_energy=halo.all_sum(-torch.sum(torch.sum(pos * gv, dim=-1) * active_f), mesh),
        max_velocity=torch.sqrt(halo.all_max(torch.amax(vsq), mesh)),
        pressure_iterations=pres.iterations,
        pressure_residual=pres.residual,
        max_pressure=halo.all_max(torch.amax(torch.abs(pres.pressure)), mesh),
        max_divergence=halo.all_max(torch.amax(torch.abs(_rhs_local(g, cfg, mesh) * cfg.cell_size)), mesh),
        particle_count=halo.all_sum(act.sum(dtype=torch.int32), mesh),
        substeps=torch.tensor(1, dtype=torch.int32, device=dev),
        overflow_count=halo.all_sum(slot_grid.overflow.sum(dtype=torch.int32), mesh),
        particles_lost=lost,
        correction_uncorrected=halo.all_sum(corr_unc, mesh),
    )
    new_state = state._replace(
        position=pos, velocity=nvel, affine=naff, active=act,
        grid=grids.MacGrid(u=g.u, v=g.v, w=g.w, cell_type=g.cell_type),
        time=state.time + dt, pressure=pres.pressure,
    )
    return new_state, diag


def _extended_faces(g: LocalGrid, mesh: RankMesh) -> grids.MacGrid:
    """The faces of the ghost-extended tile: u, v with a ghost layer each
    side, w with the neighbour-below's face nzl-1 and the neighbour-above's
    face 1 around the tile's nzl+1."""
    w_lo, _ = ghosts_z(g.w[:, :, :-1], mesh)
    _, w_hi = ghosts_z(g.w[:, :, 1:], mesh)
    return grids.MacGrid(u=pad_z(g.u, mesh), v=pad_z(g.v, mesh), w=torch.cat([w_lo, g.w, w_hi], dim=-1),
                         cell_type=None)


def _remove_boundary_normals_local(g: LocalGrid, d: int, ndev: int) -> LocalGrid:
    u, v, w = g.u.clone(), g.v.clone(), g.w.clone()
    u[0] = 0.0
    u[-1] = 0.0
    v[:, 0] = 0.0
    v[:, -1] = 0.0
    if d == 0:
        w[:, :, 0] = 0.0
    if d == ndev - 1:
        w[:, :, -1] = 0.0
    return g._replace(u=u, v=v, w=w)


def _correct_positions_local(pos, act, slot_grid, data_ext, cfg: SimConfig, cfg_e: SimConfig, dt, seed: int,
                             z0: int = 0):
    """``correction.correct_positions`` against the ghost-extended slot grid
    (kernel E), the owned cells' springs cropped back out. ``z0`` is the
    global z of local cell 0: the jitter hashes global cells, so the ghost
    layer (global z0 - 1) hashes as its owner's edge layer does."""
    kc = min(cfg.correction_capacity, slot_grid.capacity)
    res_pos = data_ext[slots_mod.COL_POS][:, :kc]  # (3, KC, nx, ny, nzl+2)
    res_mask = data_ext[slots_mod.COL_MASK][:kc]
    re2 = cfg.cell_size * cfg.cell_size / 2.0
    springs = correction_mod._springs(res_pos, res_mask, seed, (0, 0, z0 - 1), re2, cfg_e)
    springs = springs[..., 1:-1]  # the owned cells: (3, KC, nx, ny, nzl)

    window = kc * cfg.nx * cfg.ny * slot_grid.data.shape[-1]
    slot_of = torch.clamp(slot_grid.slot_of, max=window)
    spring = slots_mod.gather_per_particle(springs, slot_grid._replace(slot_of=slot_of))

    # rows past the window: a compacted pass against the extended field
    truncated = act & (slot_grid.slot_of >= window)
    oidx, ospring = correction_mod.overflow_springs(
        pos, truncated, res_pos, res_mask, re2, cfg_e, cfg.correction_overflow_capacity
    )
    return correction_mod.move(pos, act, spring, oidx, ospring, cfg, dt)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def _check(cfg: SimConfig, ndev: int) -> None:
    if cfg.nz % ndev != 0:
        raise ValueError(f"nz={cfg.nz} not divisible by {ndev} ranks")
    if cfg.nz // ndev < int(np.ceil(cfg.cfl_number)) + 1:
        raise ValueError(
            f"z-slab width {cfg.nz // ndev} too thin for CFL {cfg.cfl_number} (particles could skip a slab)"
        )


def _check_local(state: SimState, cfg: SimConfig, mesh: RankMesh) -> None:
    nzl = cfg.nz // mesh.size
    if tuple(state.grid.cell_type.shape) != (cfg.nx, cfg.ny, nzl):
        raise ValueError(
            f"substep_z takes a rank's share (zshard_state): cell_type {tuple(state.grid.cell_type.shape)}, "
            f"expected {(cfg.nx, cfg.ny, nzl)}"
        )
    if state.position.device != mesh.device:
        raise ValueError(f"the state lies on {state.position.device}, the mesh's device is {mesh.device}")


def substep_z(state: SimState, cfg: SimConfig, dt, mesh: RankMesh, draws: Optional[Draws] = None):
    """One explicitly sharded substep on this rank's share (see
    :func:`zshard_state`); returns (the rank's new share, diagnostics
    reduced over the ranks). `draws` as in the dense substep."""
    _check(cfg, mesh.size)
    _check_local(state, cfg, mesh)
    draws = Draws(state.generator) if draws is None else draws
    return _local_substep(state, cfg, dt, mesh, draws)


def zshard_state(
    state: SimState, cfg: SimConfig, mesh: RankMesh, per_device_capacity: Optional[int] = None,
    slack: float = 1.5,
) -> SimState:
    """This rank's share of a global state (every rank passes the same
    one), on the mesh's device: the particles of its z-slab in a block of
    ``per_device_capacity`` rows (default: `slack` x the busiest slab's
    count, 256-aligned, the same on every rank) and the grid's z-tile.
    Spatial decomposition is unbalanced for concentrated seeds, as the
    JAX package notes; a slab that later outgrows its block drops the
    excess into ``Diagnostics.particles_lost``."""
    ndev = mesh.size
    if cfg.nz % ndev != 0:
        raise ValueError(f"nz={cfg.nz} not divisible by {ndev} ranks")
    nzl = cfg.nz // ndev
    d = mesh.rank

    pos = state.position.detach().cpu().numpy()
    act = state.active.cpu().numpy()
    zc = np.clip(np.floor((pos[:, 2] - cfg.grid_offset[2]) / cfg.cell_size).astype(int), 0, cfg.nz - 1)
    owner = np.where(act, zc // nzl, -1)
    counts = np.bincount(owner[owner >= 0], minlength=ndev)
    if per_device_capacity is None:
        n_even = -(-int(act.sum()) // ndev)
        nl = int(max(counts.max(), n_even, 256) * slack)
        nl = -(-nl // 256) * 256
    else:
        nl = per_device_capacity
        if counts.max() > nl:
            raise ValueError(f"busiest slab holds {counts.max()} particles > per_device_capacity {nl}")

    ids = torch.from_numpy(np.flatnonzero(owner == d))
    dev = mesh.device

    def rows(x):
        out = torch.zeros((nl, *x.shape[1:]), dtype=x.dtype, device=dev)
        out[: ids.shape[0]] = x.detach()[ids.to(x.device)].to(dev)
        return out

    def tile(x, extra=0):
        return x.detach()[:, :, d * nzl : (d + 1) * nzl + extra].to(dev).contiguous()

    active = torch.zeros((nl,), dtype=torch.bool, device=dev)
    active[: ids.shape[0]] = True
    g = state.grid
    return state._replace(
        position=rows(state.position), velocity=rows(state.velocity), affine=rows(state.affine),
        active=active,
        grid=grids.MacGrid(u=tile(g.u), v=tile(g.v), w=tile(g.w, 1), cell_type=tile(g.cell_type)),
        solid=state.solid.to(dev), sources=type(state.sources)(*(t.to(dev) for t in state.sources)),
        time=state.time.to(dev), pressure=tile(state.pressure),
    )


def gather_state(state: SimState, cfg: SimConfig, mesh: RankMesh) -> SimState:
    """The global state from the ranks' shares, on every rank (the JAX
    package's sharded arrays are global and need no such step): particle
    rows in rank order, the grid's tiles along z, w's top face from the
    last rank."""
    nzl = cfg.nz // mesh.size
    g = state.grid

    def cat_rows(x):
        return halo.all_gather(x, mesh, dim=0)

    def cat_z(x):
        return halo.all_gather(x.contiguous(), mesh, dim=2)

    w_all = halo.all_gather(g.w.contiguous(), mesh, dim=2)  # (nx, ny, ndev*(nzl+1))
    keep = [r * (nzl + 1) + z for r in range(mesh.size) for z in range(nzl)] + [mesh.size * (nzl + 1) - 1]
    w = w_all[:, :, torch.tensor(keep, device=w_all.device)]
    return state._replace(
        position=cat_rows(state.position), velocity=cat_rows(state.velocity),
        affine=cat_rows(state.affine), active=cat_rows(state.active),
        grid=grids.MacGrid(u=cat_z(g.u), v=cat_z(g.v), w=w, cell_type=cat_z(g.cell_type)),
        pressure=cat_z(state.pressure),
    )


def _cfl_dt_z(state: SimState, cfg: SimConfig, mesh: RankMesh) -> torch.Tensor:
    """``step.cfl_dt`` over every rank's particles."""
    sq = torch.where(state.active, torch.sum(state.velocity**2, dim=-1), torch.zeros_like(state.velocity[:, 0]))
    vmax = torch.sqrt(halo.all_max(torch.amax(sq), mesh))
    return cfg.cell_size / torch.clamp(vmax, min=1e-30)


def step_z(state: SimState, cfg: SimConfig, dt, mesh: RankMesh, draws: Optional[Draws] = None):
    """The CFL-substepped driver over :func:`substep_z` (cf. ``step.step``);
    a host loop reading the remaining time once a substep, where the JAX
    package has a ``lax.while_loop``. Lost particles add up over the
    substeps; the other fields are the last substep's."""
    dev = state.position.device
    remaining = torch.as_tensor(dt, dtype=cfg.dtype, device=dev)
    diag = None
    lost = torch.zeros((), dtype=torch.int32, device=dev)
    nsub = 0
    while bool(remaining > 0.0):
        ts = torch.minimum(cfg.cfl_number * _cfl_dt_z(state, cfg, mesh), remaining)
        state, diag = substep_z(state, cfg, ts, mesh, draws)
        lost = lost + diag.particles_lost
        remaining = remaining - ts
        nsub += 1
    if diag is None:
        diag = Diagnostics.zeros(dev, cfg.dtype)
    return state, diag._replace(
        particles_lost=lost, substeps=torch.tensor(nsub, dtype=torch.int32, device=dev)
    )

