"""Slab-tiled substep (port of ``libfluid_tpu.sim.bigstep``).

The same stage semantics as :func:`libfluid_tpu_torch.sim.step.substep`,
with the two slot-grid passes (P2G and the position-correction springs)
streamed over ``slabs`` tiles along x, the major axis of the cell index: a
slab's slots are the contiguous cell window ``slotsort.expand_range`` serves
(kernel A), with one halo layer of cells on each side. Only a slab's
interior faces and springs are kept, so each contribution counts once; P2G
accumulates UNNORMALIZED momentum and weight across slabs and normalizes
once. The dense slot grid at 256^3 (BASELINE config 5) is 12.9 GB; a slab
window of 16 at that size is 0.91 GB.

What the JAX package does for TPU memory and the port does not:

- ``sort_rank_major``'s ``pad_cols`` (payload padding for the TPU expand
  kernel's block reads) does not exist here;
- a slab's positions stay in world coordinates: its config carries the
  world offset of its first layer (kernel B takes the offset), where the
  JAX package shifts x into slab-local coordinates. Kernel E then sees
  the dense path's coordinates and gives its springs bit for bit (its sum
  ``x_i * sum(w) - sum(w * x_j)`` rounds with the size of x, so the shift
  moved a 256^3 substep's positions by up to 6.4e-4 from the dense one);
- kernel B writes the hi face planes too, so the global u plane x = nx is
  the last slab's face ``sx + 1`` (its pad layer holds no particles)
  instead of a second expansion and ``_p2g_hi_plane``;
- G2P: kernel D reads the faces directly and builds no sample table, so
  :func:`_g2p_tiled` is kernel D over the whole grid; the JAX package's
  slab-built (C, 64) table and its 2^20-particle chunks are not needed.

Pressure, extrapolation and collisions run dense.

``step.step`` takes this substep where :func:`slab_count` gives more than
one slab, which it derives from the grid size alone (16 at 256^3, the
count BASELINE config 5 runs). Each call is a ``substep`` span of
:mod:`libfluid_tpu_torch.profiling` holding the dense substep's stage spans
(a slab's window of the slot grid under ``sort``, as the dense slot grid's
build is) and a ``slab`` span around each slab's pass in P2G and in the
correction; the counter ``bigstep.slabs`` adds the slab count once a
substep.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from libfluid_tpu_torch import grids, profiling
from libfluid_tpu_torch.config import SimConfig, TransferScheme
from libfluid_tpu_torch.sim import correction as correction_mod
from libfluid_tpu_torch.sim import extrapolation as extrapolation_mod
from libfluid_tpu_torch.sim import kernels
from libfluid_tpu_torch.sim import pressure as pressure_mod
from libfluid_tpu_torch.sim import slots as slots_mod
from libfluid_tpu_torch.sim import slotsort
from libfluid_tpu_torch.sim import sources as sources_mod
from libfluid_tpu_torch.sim import transfers
from libfluid_tpu_torch.sim.state import SimState
from libfluid_tpu_torch.sim.step import Diagnostics, Draws, _add_gravity, _advect, _collide, _diagnostics

# Cells above which step tiles its substeps, and FLIP's G2P takes the
# combined grid new - blend * old through _g2p_tiled (the JAX package's
# switch to its slab-built table). Module-level so tests can lower it.
_G2P_TILED_THRESHOLD = 1 << 21
# Cells a slab may hold (its two halo layers not counted) where step tiles.
# Module-level so tests can lower it.
_SLAB_CELLS = 1 << 20


def slab_count(cfg: SimConfig) -> int:
    """The x-slabs that ``step.step`` tiles a substep of `cfg` over: 1 (the
    dense substep) up to ``_G2P_TILED_THRESHOLD`` cells, else the smallest
    divisor of nx whose slabs hold at most ``_SLAB_CELLS`` cells (one layer a
    slab where no divisor does)."""
    if cfg.num_cells <= _G2P_TILED_THRESHOLD:
        return 1
    nx, ny, nz = cfg.grid_size
    return next((d for d in range(1, nx + 1) if nx % d == 0 and nx // d * ny * nz <= _SLAB_CELLS), nx)


def _slab_cfg(cfg: SimConfig, sx: int, s: int = 0) -> SimConfig:
    """Slab s's config: (sx + 2) x-layers with the halos, its first layer
    global layer s*sx - 1 (the JAX package's has x offset 0 and takes
    shifted positions)."""
    return dataclasses.replace(
        cfg,
        grid_size=(sx + 2, cfg.ny, cfg.nz),
        grid_offset=(_slab_x_offset(s, sx, cfg), cfg.grid_offset[1], cfg.grid_offset[2]),
    )


def _slab_x_offset(s: int, sx: int, cfg: SimConfig) -> float:
    """World x of slab s's local layer 0 (global layer s*sx - 1), rounded
    as the JAX package's float32 arithmetic rounds it."""
    f = np.float32
    return float((f(s) * f(sx) - f(1.0)) * f(cfg.cell_size) + f(cfg.grid_offset[0]))


@profiling.spanned("substep")
def substep_tiled(
    state: SimState, cfg: SimConfig, dt, slabs: int, draws: Optional[Draws] = None
) -> Tuple[SimState, Diagnostics]:
    """One time step of size dt with the slot-grid passes tiled over x-slabs.

    Stage semantics match :func:`step.substep` for all three transfer
    schemes. FLIP above ``_G2P_TILED_THRESHOLD`` cells uses the linearity of
    interpolation: v = blend*v_p + interp(new - blend*old). `draws`
    supplies the random numbers (default: the state's generator), in the
    dense substep's order.
    """
    draws = Draws(state.generator) if draws is None else draws
    nx, ny, nz = cfg.grid_size
    if nx % slabs != 0:
        raise ValueError(f"slabs ({slabs}) must divide nx ({nx})")
    profiling.count("bigstep.slabs", slabs)
    sx = nx // slabs
    nynz = ny * nz
    k = cfg.max_neighbors_per_cell
    slab_c = (sx + 2) * nynz
    use_affine = cfg.scheme == TransferScheme.APIC
    dev = state.position.device
    dt = torch.as_tensor(dt, dtype=cfg.dtype, device=dev)

    # --- advection + collisions ---
    old_position = state.position
    with profiling.span("advect"):
        state = _advect(state, cfg, dt)
    state = _collide(state, old_position, cfg)

    # --- sort; seeding sources re-sorts ---
    with profiling.span("sort"):
        rs = slotsort.sort_rank_major(state, cfg)
    n_src = state.sources.cells.shape[0]
    if n_src > 0:
        with profiling.span("sources"):
            state = sources_mod.seed_from_jitter(
                rs.state, rs.counts.reshape(cfg.grid_size), cfg, draws.source_jitter(n_src, cfg)
            )
        with profiling.span("sort"):
            rs = slotsort.sort_rank_major(state, cfg)
    state = rs.state
    old_position = state.position
    n = state.position.shape[0]
    kc_full = cfg.num_cells * k
    slot_of = torch.clamp(rs.key_sorted, max=kc_full)

    # one x-layer of cells on each side, so every slab slices a full
    # (sx+2)-layer window: the pad cells hold no particles
    ins2 = rs.ins.reshape(k, cfg.num_cells)
    ins_p = torch.cat([ins2[:, :1].expand(k, nynz), ins2, ins2[:, -1:].expand(k, nynz)], dim=1)
    cnt_p = torch.nn.functional.pad(rs.counts, (nynz, nynz))
    rs_p = rs._replace(ins=ins_p.reshape(-1), counts=cnt_p)
    pcfg = dataclasses.replace(cfg, grid_size=(nx + 2, ny, nz))

    kcor = min(cfg.correction_capacity, k)
    # one jitter seed for the whole substep, drawn where the dense substep
    # draws it relative to the sources' draw: the hash of (seed, global
    # cell, slot) gives every slab the dense path's jitter
    seed = draws.correction_seed() if cfg.enable_position_correction else 0
    re2 = cfg.cell_size * cfg.cell_size / 2.0

    # --- pass 1: P2G sums and correction springs, slab by slab ---
    fshapes = kernels.face_shapes(cfg)
    nums = [torch.zeros(shp, dtype=cfg.dtype, device=dev) for shp in fshapes]
    dens = [torch.zeros(shp, dtype=cfg.dtype, device=dev) for shp in fshapes]
    springs_g = (
        torch.zeros((3, kcor, nx, ny, nz), dtype=cfg.dtype, device=dev)
        if cfg.enable_position_correction else None
    )

    # each slab's two passes as functions of their own: a profiler's trace
    # places a launch by the Python function that made it

    def p2g_slab(s: int, data: torch.Tensor) -> None:
        # kernel B on the slab; its interior faces: u local [1, sx+1), v/w
        # x-cells [1, sx+1); the last slab also owns u face sx+1, the
        # global plane x = nx
        num, den = kernels.p2g_faces(data, _slab_cfg(cfg, sx, s))
        x0 = s * sx
        hi = sx + 2 if s == slabs - 1 else sx + 1
        nums[0][x0 : x0 + hi - 1] += num[0][1:hi]
        dens[0][x0 : x0 + hi - 1] += den[0][1:hi]
        for a in (1, 2):
            nums[a][x0 : x0 + sx] += num[a][1 : sx + 1]
            dens[a][x0 : x0 + sx] += den[a][1 : sx + 1]

    def springs_slab(s: int, data: torch.Tensor) -> None:
        # kernel E on the slab, its interior cells kept
        spr = correction_mod._springs(
            data[0:3, :kcor], data[3, :kcor], seed, (s * sx - 1, 0, 0), re2, _slab_cfg(cfg, sx, s)
        )  # (3, KC, sx+2, ny, nz)
        springs_g[:, :, s * sx : (s + 1) * sx] = spr[:, :, 1 : sx + 1]

    for s in range(slabs):
        with profiling.span("sort"):
            # padded cell s*sx*nynz = global layer s*sx - 1
            data = slotsort.expand_range(rs_p, pcfg, s * sx * nynz, slab_c)
            data = data.reshape(slots_mod.WIDTH, k, sx + 2, ny, nz)
        with profiling.span("p2g"), profiling.span("slab"):
            p2g_slab(s, data)
        if springs_g is not None:
            with profiling.span("correction"), profiling.span("slab"):
                springs_slab(s, data)
        del data

    # --- the slot-overflow rows (slotsort parks them at n_kept...), merged
    # into the slabs' sums, then normalized ---
    with profiling.span("p2g"):
        overflow = (rs.key_sorted >= kc_full) & (rs.key_sorted < kc_full + n)
        u, v, w = transfers.p2g_merge_overflow(
            nums, dens, state.position, state.velocity, state.affine, state.active, overflow, cfg,
            start=rs.n_kept,
        )
        grid = grids.mark_cells(state.grid._replace(u=u, v=v, w=w), rs.counts.reshape(cfg.grid_size))
        old_grid = None
        if use_affine:
            grid = grids.remove_boundary_normal_velocities(grid)
        elif cfg.scheme == TransferScheme.FLIP:
            old_grid = grids.remove_boundary_normal_velocities(grid)

    # --- gravity + pressure (dense) ---
    grid = _add_gravity(grid, cfg, dt)
    with profiling.span("pressure"):
        pres = pressure_mod.solve(grid, cfg, dt, x0=state.pressure)
        grid = pressure_mod.apply_pressure(grid, pres.pressure, cfg, dt)

    # --- position correction from the accumulated spring field ---
    corr_uncorrected = torch.zeros((), dtype=torch.int32, device=dev)
    if springs_g is not None:
        with profiling.span("correction"):
            m = kcor * cfg.num_cells
            has = slot_of < m
            spring = springs_g.reshape(3, m)[:, torch.where(has, slot_of, 0).long()].t()
            spring = torch.where(has[:, None], spring, torch.zeros_like(spring))
            del springs_g
            truncated = state.active & ~has
            trunc_start = torch.sum(torch.clamp(rs.counts, max=kcor), dtype=torch.int32)
            corr_uncorrected = torch.clamp(
                truncated.sum(dtype=torch.int32) - cfg.correction_overflow_capacity, min=0
            )
            oidx, ospring = _overflow_springs_lazy(
                state.position, truncated, rs, kcor, re2, cfg,
                cfg.correction_overflow_capacity, trunc_start,
            )
            state = state._replace(position=correction_mod.move(
                state.position, state.active, spring, oidx, ospring, cfg, dt))
    state = _collide(state, old_position, cfg)

    # --- velocity extrapolation + G2P ---
    with profiling.span("extrapolate"):
        grid = extrapolation_mod.extrapolate(grid, cfg)
    with profiling.span("g2p"):
        if cfg.scheme == TransferScheme.FLIP:
            blend = cfg.blending_factor
            if cfg.num_cells <= _G2P_TILED_THRESHOLD:
                vel = transfers.g2p_flip(grid, old_grid, state.position, state.velocity, cfg)
            else:
                # interp(new) + blend * (v_p - interp(old)) == blend * v_p +
                # interp(new - blend * old): one G2P of the combined grid
                comb = grid._replace(
                    u=grid.u - blend * old_grid.u,
                    v=grid.v - blend * old_grid.v,
                    w=grid.w - blend * old_grid.w,
                )
                vi, _ = _g2p_tiled(comb, state, rs, cfg, slabs)
                vel = blend * state.velocity + vi
            affine = state.affine
        else:
            # PIC keeps G2P's affine rows as the JAX package's substep_tiled
            # does (its dense substep keeps the particles'); PIC's P2G reads none
            vel, affine = _g2p_tiled(grid, state, rs, cfg, slabs)
        vel = torch.where(state.active[:, None], vel, state.velocity)
        affine = torch.where(state.active[:, None, None], affine, state.affine)

    state = state._replace(
        velocity=vel, affine=affine, grid=grid, time=state.time + dt, pressure=pres.pressure
    )

    with profiling.span("diagnostics"):
        diag = _diagnostics(state, pres, cfg, rs.n_overflow, corr_uncorrected)
    return state, diag


def _overflow_springs_lazy(
    position, truncated, rs, kcor: int, re2: float, cfg: SimConfig, cap: int, trunc_start
):
    """``correction.overflow_springs`` without a dense slot grid: a resident
    neighbour's row is read through the insertion table (slot (r, c) is
    sorted row ``ins[r*C + c]`` when ``counts[c] > r``). Plain PyTorch, as
    the JAX package's jnp. Returns (indices (cap,), springs (cap, 3)); an
    index of n marks an unused row."""
    n = position.shape[0]
    cap = min(cap, n)
    num_cells = cfg.num_cells
    k = cfg.max_neighbors_per_cell
    dev = position.device

    idx = trunc_start + torch.arange(cap, dtype=torch.int32, device=dev)
    idx = torch.where(
        truncated[torch.clamp(idx, max=n - 1).long()] & (idx < n), idx, torch.full_like(idx, n)
    )
    ok = idx < n
    p = position[torch.clamp(idx, max=n - 1).long()]  # (cap, 3)

    cell3 = grids.cell_index_of(p, cfg)
    offs = torch.tensor(slots_mod.NEIGHBOR_OFFSETS, dtype=torch.int32, device=dev)
    nb3 = cell3[:, None, :] + offs[None]
    dims = torch.tensor(cfg.grid_size, dtype=torch.int32, device=dev)
    inb = torch.all((nb3 >= 0) & (nb3 < dims), dim=-1)  # (cap, 27)
    cellflat = grids.flat_cell_index(torch.minimum(torch.clamp(nb3, min=0), dims - 1), cfg).long()

    ins2 = rs.ins.reshape(k, num_cells)
    k_iota = torch.arange(kcor, dtype=torch.int32, device=dev)
    rows = ins2[k_iota.long()[None, None, :], cellflat[..., None]]  # (cap, 27, KC)
    valid = (rs.counts[cellflat][..., None] > k_iota[None, None, :]) & inb[..., None]
    rows = torch.clamp(rows, max=rs.payT.shape[1] - 1).long()
    nbp = rs.payT[0:3][:, rows]  # (3, cap, 27, KC)
    nbm = valid.to(p.dtype)

    pt = p.t()
    d2 = sum((pt[i][:, None, None] - nbp[i]) ** 2 for i in range(3))
    w = correction_mod._pair_weight(d2, re2) * nbm
    spring = torch.stack(
        [torch.sum(w * (pt[i][:, None, None] - nbp[i]), dim=(1, 2)) for i in range(3)], dim=-1
    )
    return idx, spring * ok[:, None].to(spring.dtype)


def _g2p_tiled(grid: grids.MacGrid, state: SimState, rs, cfg: SimConfig, slabs: int):
    """G2P of the whole grid: ``transfers.g2p_pic`` (kernel D on the card,
    the plain table on the CPU). The JAX package builds its (C, 64) sample
    table slab by slab and applies it in 2^20-particle chunks to bound TPU
    memory; kernel D reads the faces and holds no table, so neither bound
    is needed. `rs` and `slabs` are the JAX signature's."""
    return transfers.g2p_pic(grid, state.position, cfg)
