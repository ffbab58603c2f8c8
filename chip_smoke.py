#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``libfluid_tpu_torch``) on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

Phases, one line of output each (or a few):

1. the card's name and power limit (nvidia-smi);
2. build of the CUDA kernels from ``libfluid_tpu_torch/csrc`` (one nvcc per
   source, in parallel, sm_90a);
3. each kernel (A-F) against its plain PyTorch version on the card, at the
   shapes the 128^3 main path gives it (the state after one substep with
   position correction on, meshed on the 261^3-node grid), with error and
   median time of both; then the backward kernels B' (at 64^3: the plain
   autograd of P2G does not fit the card at 128^3) and D' (at 128^3)
   against the autograd of their plain versions, and kernel C's bfloat16
   instance against the plain bfloat16 stencil on every level and mode;
4. a seeded 32^3 dam-break with position correction off, and a 32^3 scene
   with the default options (position correction, a solid block, a
   source), each run for 2 substeps on the card (kernels) and on the CPU
   (plain versions) and compared; the second is then meshed, compared;
5. gradient parity, card against CPU, at 32^3: the gradient of a loss on
   the end state of 2 substeps with respect to the initial velocities, for
   both scenes of phase 4, and the gradient of a loss on the mesh vertices
   of the scene's end state (66^3 mesher grid) with respect to the
   positions; then 3 steps of gradient descent at 32^3, whose loss must
   fall;
6. the main path: the 128^3 APIC dam-break with position correction on
   (~2.0M particles), one warm-up substep, 5 timed substeps, one CFL
   ``step(1/60)``, then ``generate_mesh`` on the 260^3-cell mesher grid,
   with the healthy-output checks and the launch counts;
7. the same dam-break with position correction off, 2 substeps;
8. the gradient path: the 128^3 correction-off dam-break, 3 steps of
   gradient descent on the initial velocities through 2 unrolled substeps
   (forward and backward ms, loss, gradient norm, CG iterations of the
   forward and adjoint solves, peak memory);
9. the 128^3 dam-break with FLIP and the bfloat16 V-cycle ("mg16"), 2
   substeps;
10. the testbed CLI, setup 4 (jet source + obstacle), 2 frames with an OBJ
    export every frame.

Every path is driven with the launch counts set to 0 just before it and
read just after; each fails if a kernel of its path was not launched. Any
failed check raises, so the script exits non-zero and prints no result.
The line before the last holds the per-kernel JSON record (launches of the
main path); the last line is ``{"ok": true, "device": {...}}``. Needs a
CUDA device; never falls back to the CPU for the main path.
"""

import dataclasses
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from libfluid_tpu_torch import _build
from libfluid_tpu_torch.config import MesherConfig, SimConfig, SolverConfig, TransferScheme
from libfluid_tpu_torch import sim
from libfluid_tpu_torch.io.obj import load_obj
from libfluid_tpu_torch.mesher import generate_mesh, surface
from libfluid_tpu_torch.sim import correction, kernels, multigrid, pressure, slotsort, sources, transfers
from libfluid_tpu_torch.sim.state import particle_count, set_solid
from libfluid_tpu_torch.testbed import __main__ as testbed_cli

# name -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "expand": ("libfluid_tpu_torch/csrc/expand.cu", "libfluid_tpu/sim/slotsort.py:78"),
    "p2g": ("libfluid_tpu_torch/csrc/p2g.cu", "libfluid_tpu/sim/kernels.py:58"),
    "stencil": ("libfluid_tpu_torch/csrc/stencil.cu", "libfluid_tpu/sim/multigrid.py:127"),
    "g2p": ("libfluid_tpu_torch/csrc/g2p.cu", "libfluid_tpu/sim/transfers.py:177,508"),
    "correction": ("libfluid_tpu_torch/csrc/correction.cu", "libfluid_tpu/sim/kernels.py:284"),
    "surface": ("libfluid_tpu_torch/csrc/surface.cu", "libfluid_tpu/mesher/surface.py:164"),
    # the backward kernels and kernel C's bfloat16 instance
    "p2g_bwd": ("libfluid_tpu_torch/csrc/p2g_bwd.cu", "libfluid_tpu/sim/kernels.py:58"),
    "g2p_bwd": ("libfluid_tpu_torch/csrc/g2p_bwd.cu", "libfluid_tpu/sim/transfers.py:177,508"),
    "stencil16": ("libfluid_tpu_torch/csrc/stencil.cu", "libfluid_tpu/sim/multigrid.py:127"),
}
FORWARD_KERNELS = ("expand", "p2g", "stencil", "g2p", "correction", "surface")
GRAD_KERNELS = ("expand", "p2g", "p2g_bwd", "stencil", "g2p", "g2p_bwd")
# the gradient descent: the velocity offset of its target run, and its
# learning rate (tuned at 32^3 on the CPU; the per-particle gradient does
# not depend on the grid size)
GRAD_OFFSET = (40.0, 0.0, -25.0)
GRAD_LR = 200.0
DT = 0.02  # the dam-break substep of the JAX package's benchmark
REPS = 10
PLAIN_REPS_SLOW = 3  # repetitions of the plain correction and surface passes
# the testbed mesher's parameters (cell 0.5, extent 2.0, radius 0.5, offset
# -1) with the grid scaled to the 128^3 domain as 104 cells cover 50
MESH_128 = MesherConfig(
    grid_size=(260, 260, 260), cell_size=0.5, grid_offset=(-1.0, -1.0, -1.0),
    particle_extent=2.0, particle_radius=0.5, max_triangles=1 << 21,
)
# the same mesher for the 32^3 scenes
MESH_66 = MesherConfig(grid_size=(66, 66, 66), cell_size=0.5, grid_offset=(-1.0, -1.0, -1.0),
                       particle_extent=2.0, particle_radius=0.5, max_triangles=1 << 18)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def dam_break(n: int, device, capacity: int, correct: bool = True):
    """The dam-break of the JAX package's 128^3 benchmark scaled to n^3
    cells: no obstacles, position correction on unless `correct` is False."""
    cfg = SimConfig(
        grid_size=(n, n, n), cell_size=1.0, gravity=(0.0, -981.0, 0.0),
        particle_capacity=capacity, scheme=TransferScheme.APIC,
        has_obstacles=False, enable_position_correction=correct,
    )
    state = sim.new_state(cfg, device)
    state = sim.seed_box(state, cfg, (1.0, 1.0, 1.0), (n / 2 - 1.0,) * 3)
    return cfg, state


def median_ms(fn, reps: int = REPS) -> float:
    """Median device time of `fn` over `reps` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def close(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> bool:
    return bool(torch.all(torch.abs(got - want) <= atol + rtol * torch.abs(want)))


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.max(torch.abs(got - want)))


def kernel_phases(cfg, state) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    out = {}

    rs = slotsort.sort_rank_major(state, cfg)
    got = slotsort.expand(rs.payT, rs.ins, rs.counts)
    want = slotsort._expand_torch(rs.payT, rs.ins, rs.counts)
    check(torch.equal(got, want), "expand kernel differs from its plain version")
    out["expand"] = dict(
        max_abs_err=max_err(got, want),
        ms=median_ms(lambda: slotsort.expand(rs.payT, rs.ins, rs.counts)),
        plain_ms=median_ms(lambda: slotsort._expand_torch(rs.payT, rs.ins, rs.counts)),
    )
    log(f"kernel expand: exact, shape {tuple(got.shape)}, {out['expand']}")

    nx, ny, nz = cfg.grid_size
    data = got.reshape(16, cfg.max_neighbors_per_cell, nx, ny, nz)
    del got, want
    (kn, kd) = kernels.p2g_faces(data, cfg)
    (pn, pd) = transfers._p2g_slots_torch(data, cfg)
    errs, abs_errs = [], []
    for a in range(3):
        ko = transfers._normalize(kn[a], kd[a])
        po = transfers._normalize(pn[a], pd[a])
        errs.append(max_err(ko, po) / (float(torch.max(torch.abs(po))) + 1e-9))
        abs_errs.append(max_err(ko, po))
    check(max(errs) < 2e-5, f"p2g normalized error {errs} >= 2e-5")
    del kn, kd, pn, pd
    out["p2g"] = dict(
        max_abs_err=max(abs_errs),
        ms=median_ms(lambda: kernels.p2g_faces(data, cfg)),
        plain_ms=median_ms(lambda: transfers._p2g_slots_torch(data, cfg)),
    )
    log(f"kernel p2g: normalized error {max(errs):.3e} (< 2e-5), {out['p2g']}")
    del data, rs

    levels = multigrid.build_levels(state.grid.cell_type)
    gen = torch.Generator(device=state.position.device).manual_seed(0)
    worst = 0.0
    for lvl in levels:
        x = torch.randn(lvl.fluid.shape, generator=gen, device=lvl.fluid.device) * lvl.fluid
        b = torch.randn(lvl.fluid.shape, generator=gen, device=lvl.fluid.device) * lvl.fluid
        for mode in (multigrid.MODE_APPLY, multigrid.MODE_JACOBI, multigrid.MODE_RESIDUAL):
            got = multigrid.stencil(lvl, x, b, mode, multigrid._SMOOTH_DAMP)
            want = multigrid._stencil_torch(lvl, x, b, mode, multigrid._SMOOTH_DAMP)
            check(close(got, want, 1e-6, 1e-5),
                  f"stencil level {tuple(lvl.fluid.shape)} mode {mode} error {max_err(got, want)}")
            worst = max(worst, max_err(got, want))
    lvl = levels[0]
    x = torch.randn(lvl.fluid.shape, generator=gen, device=lvl.fluid.device) * lvl.fluid
    b = torch.randn(lvl.fluid.shape, generator=gen, device=lvl.fluid.device) * lvl.fluid
    out["stencil"] = dict(
        max_abs_err=worst,
        ms=median_ms(lambda: multigrid.stencil(lvl, x, b, multigrid.MODE_JACOBI, 0.8)),
        plain_ms=median_ms(lambda: multigrid._stencil_torch(lvl, x, b, multigrid.MODE_JACOBI, 0.8)),
    )
    log(f"kernel stencil: {len(levels)} levels {[tuple(l.fluid.shape) for l in levels]} x 3 modes "
        f"within rtol 1e-6/atol 1e-5, time at {tuple(lvl.fluid.shape)} Jacobi mode, {out['stencil']}")
    del levels, lvl, x, b

    grid, pos = state.grid, state.position
    vk, ak = transfers.g2p_pic(grid, pos, cfg)

    def plain():
        return transfers.g2p_from_table(transfers.build_g2p_table(grid, cfg), pos, cfg)

    vp, ap = plain()
    check(close(vk, vp, 1e-5, 1e-5) and close(ak, ap, 1e-5, 1e-5),
          f"g2p error velocity {max_err(vk, vp)} affine {max_err(ak, ap)}")
    out["g2p"] = dict(
        max_abs_err=max(max_err(vk, vp), max_err(ak, ap)),
        ms=median_ms(lambda: transfers.g2p_pic(grid, pos, cfg)),
        plain_ms=median_ms(plain),
    )
    log(f"kernel g2p: {pos.shape[0]} particles within rtol/atol 1e-5, {out['g2p']}")
    del vk, ak, vp, ap

    sb = slotsort.sort_and_build(state, cfg)
    kc = min(cfg.correction_capacity, sb.slot_grid.capacity)
    res_pos = sb.slot_grid.position[:, :kc]
    res_mask = sb.slot_grid.mask[:kc]
    re2 = cfg.cell_size**2 / 2.0
    seed = 12345
    got = kernels.correction_springs(res_pos, res_mask, re2, seed)
    want = correction._springs_torch(res_pos, res_mask, re2, seed, cfg)
    norm = max_err(got, want) / (100.0 * float(torch.max(torch.abs(res_pos))))
    check(norm < 2e-6, f"correction normalized error {norm} >= 2e-6")
    out["correction"] = dict(
        max_abs_err=max_err(got, want),
        ms=median_ms(lambda: kernels.correction_springs(res_pos, res_mask, re2, seed)),
        plain_ms=median_ms(lambda: correction._springs_torch(res_pos, res_mask, re2, seed, cfg),
                           PLAIN_REPS_SLOW),
    )
    log(f"kernel correction: springs {tuple(got.shape)} of {int(res_mask.sum())} resident slots, "
        f"normalized error {norm:.3e} (< 2e-6), plain timed over {PLAIN_REPS_SLOW} reps, "
        f"{out['correction']}")
    del sb, res_pos, res_mask, got, want

    act = state.active
    got = surface.sample_surface(pos, act, MESH_128)
    want = surface._sample_surface_torch(pos, act, MESH_128)
    err = max_err(got, want)
    check(err < 2e-3, f"surface error {err} >= 2e-3")
    check(bool((want < 0).any()), "surface: no node inside the fluid")
    out["surface"] = dict(
        max_abs_err=err,
        ms=median_ms(lambda: surface.sample_surface(pos, act, MESH_128)),
        plain_ms=median_ms(lambda: surface._sample_surface_torch(pos, act, MESH_128),
                           PLAIN_REPS_SLOW),
    )
    bin_ms = median_ms(lambda: surface.bin_particles(pos, act, MESH_128))
    log(f"kernel surface: {tuple(got.shape)} nodes from {int(act.sum())} particles, max abs "
        f"error {err:.3e} (< 2e-3); ms includes the CSR binning ({bin_ms:.3f} ms of it); "
        f"plain timed over {PLAIN_REPS_SLOW} reps, {out['surface']}")
    return out


def backward_kernel_phases(cfg, state) -> dict:
    """Kernels B' and D' against the autograd of their plain versions, and
    kernel C's bfloat16 instance against the plain bfloat16 stencil, on the
    card. `state` is the 128^3 main-path state after one substep."""
    out = {}
    device = state.position.device
    gen = torch.Generator(device=device).manual_seed(1)

    # B': the plain autograd of P2G saves ~40 GB at 128^3, so the comparison
    # runs on the 64^3 dam-break after one substep; the kernel alone is also
    # timed on the 128^3 payload
    cfg64, st64 = dam_break(64, device, 1 << 18)
    st64, _ = sim.substep(st64, cfg64, DT)
    data = slotsort.sort_and_build(st64, cfg64).slot_grid.data.contiguous()
    faces = [torch.randn(sh, generator=gen, device=device) for sh in kernels.face_shapes(cfg64) * 2]

    def plain_bwd():
        leaf = data.detach().requires_grad_()
        num, den = transfers._p2g_slots_torch(leaf, cfg64)
        return torch.autograd.grad((*num, *den), leaf, faces)[0]

    got = kernels.p2g_faces_bwd(data, faces[:3], faces[3:], cfg64)
    want = plain_bwd()
    occ = data[3] != 0
    # an empty slot's mask row has a plain cotangent that expand's backward
    # drops with the slot; B' writes 0 there
    err = max_err(got * occ, want * occ)
    rel = err / float(torch.max(torch.abs(want * occ)))
    check(rel < 1e-5, f"p2g_bwd relative error {rel} >= 1e-5")
    check(bool((got[:, ~occ] == 0).all()), "p2g_bwd: an empty slot got a cotangent")
    out["p2g_bwd"] = dict(
        max_abs_err=err,
        ms=median_ms(lambda: kernels.p2g_faces_bwd(data, faces[:3], faces[3:], cfg64)),
        plain_ms=median_ms(plain_bwd, PLAIN_REPS_SLOW),
    )
    del got, want, occ, data, faces, st64
    torch.cuda.empty_cache()
    sb = slotsort.sort_and_build(state, cfg)
    data = sb.slot_grid.data.contiguous()
    faces = [torch.randn(sh, generator=gen, device=device) for sh in kernels.face_shapes(cfg) * 2]
    ms_128 = median_ms(lambda: kernels.p2g_faces_bwd(data, faces[:3], faces[3:], cfg))
    out["p2g_bwd"]["ms_128"] = ms_128
    log(f"kernel p2g_bwd (B'): at 64^3 (the plain autograd does not fit at 128^3), relative error "
        f"{rel:.3e} (< 1e-5) on the occupied slots, empty slots 0, plain = recompute + autograd "
        f"over {PLAIN_REPS_SLOW} reps, {out['p2g_bwd']}; B' on the 128^3 payload {ms_128:.3f} ms")
    del sb, data, faces
    torch.cuda.empty_cache()

    # D' at 128^3
    grid, pos = state.grid, state.position.contiguous()
    n = pos.shape[0]
    gv = torch.randn((n, 3), generator=gen, device=device)
    ga = torch.randn((n, 3, 3), generator=gen, device=device)

    def plain_g2p_bwd():
        leaves = [t.detach().requires_grad_() for t in (grid.u, grid.v, grid.w, pos)]
        return torch.autograd.grad(transfers._g2p_plain(*leaves, cfg), leaves, (gv, ga))

    got = transfers.g2p_bwd(grid.u, grid.v, grid.w, pos, gv, ga, cfg)
    want = plain_g2p_bwd()
    # face cotangents: float32 sums of up to a few hundred particles' terms
    # in two orders (atomics here, the plain scatter there), held to 1e-4 of
    # the largest; the position cotangent is a gather, held to 1e-5
    rels = [max_err(a, b) / float(torch.max(torch.abs(b))) for a, b in zip(got, want)]
    check(max(rels[:3]) < 1e-4 and rels[3] < 1e-5,
          f"g2p_bwd relative errors (u, v, w, position) {rels}: faces >= 1e-4 or position >= 1e-5")
    out["g2p_bwd"] = dict(
        max_abs_err=max(max_err(a, b) for a, b in zip(got, want)),
        ms=median_ms(lambda: transfers.g2p_bwd(grid.u, grid.v, grid.w, pos, gv, ga, cfg)),
        plain_ms=median_ms(plain_g2p_bwd, PLAIN_REPS_SLOW),
    )
    log(f"kernel g2p_bwd (D'): {n} particles, relative errors (u, v, w, position) "
        f"{[f'{r:.2e}' for r in rels]} (faces < 1e-4, position < 1e-5), plain = recompute + "
        f"autograd, "
        f"{out['g2p_bwd']}")
    del got, want, gv, ga
    torch.cuda.empty_cache()

    # stencil16 on every level and mode: the same rounding as the plain
    # bfloat16 version, so equal to within one bfloat16 rounding (2^-8)
    levels = multigrid.build_levels(state.grid.cell_type)
    worst = 0.0
    for lvl in levels:
        l16 = multigrid.MGLevel(*[f.to(torch.bfloat16) for f in lvl[:-1]], lvl.scale)
        x = (torch.randn(lvl.fluid.shape, generator=gen, device=device) * lvl.fluid).to(torch.bfloat16)
        b = (torch.randn(lvl.fluid.shape, generator=gen, device=device) * lvl.fluid).to(torch.bfloat16)
        for mode in (multigrid.MODE_APPLY, multigrid.MODE_JACOBI, multigrid.MODE_RESIDUAL):
            got = multigrid.stencil(l16, x, b, mode, multigrid._SMOOTH_DAMP).float()
            damp = float(torch.tensor(multigrid._SMOOTH_DAMP, dtype=torch.bfloat16))
            want = multigrid._stencil_torch(l16, x, b, mode, damp).float()
            check(close(got, want, 2.0**-8, 0.0),
                  f"stencil16 level {tuple(lvl.fluid.shape)} mode {mode} error {max_err(got, want)}")
            worst = max(worst, max_err(got, want))
    l16 = multigrid.MGLevel(*[f.to(torch.bfloat16) for f in levels[0][:-1]], 1.0)
    x = (torch.randn(l16.fluid.shape, generator=gen, device=device) * levels[0].fluid).to(torch.bfloat16)
    b = (torch.randn(l16.fluid.shape, generator=gen, device=device) * levels[0].fluid).to(torch.bfloat16)
    damp = float(torch.tensor(0.8, dtype=torch.bfloat16))
    out["stencil16"] = dict(
        max_abs_err=worst,
        ms=median_ms(lambda: multigrid.stencil(l16, x, b, multigrid.MODE_JACOBI, 0.8)),
        plain_ms=median_ms(lambda: multigrid._stencil_torch(l16, x, b, multigrid.MODE_JACOBI, damp)),
    )
    log(f"kernel stencil16: {len(levels)} levels x 3 modes in bfloat16, max abs error {worst:.3e} "
        f"(within 2^-8 relative), time at {tuple(l16.fluid.shape)} Jacobi mode, {out['stencil16']}")
    return out


def parity_scene(device):
    """32^3 with the default options (position correction, obstacles): the
    dam-break box thrown at a solid block, and a coercing source row."""
    cfg = SimConfig(
        grid_size=(32, 32, 32), cell_size=1.0, gravity=(0.0, -981.0, 0.0),
        particle_capacity=1 << 15, scheme=TransferScheme.APIC,
    )
    state = sim.new_state(cfg, device, 0)
    state = sim.seed_box(state, cfg, (1.0, 1.0, 1.0), (15.0, 15.0, 15.0), velocity=(150.0, 0.0, 0.0))
    solid = np.zeros(cfg.grid_size, bool)
    solid[17:21, 0:12, 4:28] = True
    state = set_solid(state, solid)
    src = sources.make_source_set(
        [[28, 20, z] for z in range(10, 15)], (-50.0, 0.0, 0.0), coerce_velocity=True, device=device,
    )
    return cfg, state._replace(sources=src)


def slice_parity(device) -> None:
    """2 substeps of the 32^3 dam-break with position correction off on the
    card (kernels) and on the CPU (plain versions), compared."""
    runs = {}
    for dev in (device, torch.device("cpu")):
        cfg, state = dam_break(32, dev, 1 << 15, correct=False)
        for _ in range(2):
            state, diag = sim.substep(state, cfg, DT)
        runs[dev.type] = (state, diag)
    (gs, gd), (cs, cd) = runs[device.type], runs["cpu"]
    check(torch.equal(gs.active.cpu(), cs.active), "32^3: active masks differ")
    pos_err = max_err(gs.position.cpu(), cs.position)
    rel = {k: max_err(getattr(gs, k).cpu(), getattr(cs, k)) / (float(torch.max(torch.abs(getattr(cs, k)))) + 1e-12)
           for k in ("velocity", "affine")}
    its = (int(gd.pressure_iterations), int(cd.pressure_iterations))
    log(f"slice parity 32^3 x 2 substeps, correction off: position err {pos_err:.3e}, velocity rel err "
        f"{rel['velocity']:.3e}, affine rel err {rel['affine']:.3e}, CG iterations gpu/cpu {its}, "
        f"overflow {int(gd.overflow_count)}/{int(cd.overflow_count)}")
    check(pos_err < 1e-4, "32^3: positions differ by >= 1e-4 cells")
    check(max(rel.values()) < 1e-3, "32^3: velocity/affine differ by >= 1e-3 of max")
    check(int(gd.particle_count) == int(cd.particle_count), "32^3: particle counts differ")
    check(int(gd.overflow_count) == int(cd.overflow_count), "32^3: overflow counts differ")
    check(abs(its[0] - its[1]) <= 1, "32^3: CG iterations differ by more than 1")
    for k in ("kinetic_energy", "potential_energy"):
        g, c = float(getattr(gd, k)), float(getattr(cd, k))
        check(abs(g - c) <= 1e-4 * abs(c), f"32^3: {k} {g} vs {c}")


def scene_parity(device) -> None:
    """2 substeps of the 32^3 scene on the card (kernels) and on the CPU
    (plain versions), then meshed, compared. Both draw their random numbers
    from equally seeded CPU generators.

    Positions: kernel E sums in another order than its plain version (its
    own bound is 2e-6 of 100 max|pos|, 6.4e-3 at 32^3) and a substep moves
    a particle by 0.07 x its spring (dt * stiffness * h / sqrt(2)), so two
    substeps may part by up to ~1e-3 cells; all but 0.1 % of particles stay
    within the correction-off check's 1e-4."""
    runs = {}
    for dev in (device, torch.device("cpu")):
        cfg, state = parity_scene(dev)
        for _ in range(2):
            state, diag = sim.substep(state, cfg, DT)
        sdf = surface.sample_surface(state.position, state.active, MESH_66)
        mesh = generate_mesh(state.position, state.active, MESH_66)
        runs[dev.type] = (state, diag, sdf, int(mesh.count))
    (gs, gd, gsdf, gcount), (cs, cd, csdf, ccount) = runs[device.type], runs["cpu"]
    check(torch.equal(gs.active.cpu(), cs.active), "32^3: active masks differ")
    per = torch.amax(torch.abs(gs.position.cpu() - cs.position), dim=1)[cs.active]
    pos_err = float(torch.max(per))
    pos_q = float(torch.quantile(per, 0.999))
    rel = {k: max_err(getattr(gs, k).cpu(), getattr(cs, k)) / (float(torch.max(torch.abs(getattr(cs, k)))) + 1e-12)
           for k in ("velocity", "affine")}
    its = (int(gd.pressure_iterations), int(cd.pressure_iterations))
    sdf_err = max_err(gsdf.cpu(), csdf)
    log(f"scene parity 32^3 x 2 substeps (correction, obstacle, source): position err {pos_err:.3e} "
        f"(99.9th percentile {pos_q:.3e}), "
        f"velocity rel err {rel['velocity']:.3e}, affine rel err {rel['affine']:.3e}, CG iterations "
        f"gpu/cpu {its}, overflow {int(gd.overflow_count)}/{int(cd.overflow_count)}, particles "
        f"{int(gd.particle_count)}/{int(cd.particle_count)}; mesh 66^3 SDF err {sdf_err:.3e}, "
        f"triangles gpu/cpu {gcount}/{ccount}")
    check(pos_err < 1e-3 and pos_q < 1e-4,
          "32^3 scene: positions differ by >= 1e-3 cells, or >= 1e-4 for 0.1 % of them")
    check(max(rel.values()) < 1e-3, "32^3: velocity/affine differ by >= 1e-3 of max")
    check(int(gd.particle_count) == int(cd.particle_count), "32^3: particle counts differ")
    check(int(gd.overflow_count) == int(cd.overflow_count), "32^3: overflow counts differ")
    check(int(gd.correction_uncorrected) == int(cd.correction_uncorrected),
          "32^3: correction_uncorrected differs")
    check(abs(its[0] - its[1]) <= 1, "32^3: CG iterations differ by more than 1")
    for k in ("kinetic_energy", "potential_energy"):
        g, c = float(getattr(gd, k)), float(getattr(cd, k))
        check(abs(g - c) <= 1e-4 * abs(c), f"32^3: {k} {g} vs {c}")
    check(sdf_err < 2e-3, f"32^3: SDF differs by {sdf_err} >= 2e-3")
    check(ccount > 0 and abs(gcount - ccount) <= 0.005 * ccount,
          f"32^3: triangle counts {gcount}/{ccount} differ by more than 0.5 %")


def rollout(state, cfg, velocity, substeps: int = 2):
    """`substeps` substeps from `state` with its velocities replaced."""
    st = state._replace(velocity=velocity)
    diags = []
    for _ in range(substeps):
        st, diag = sim.substep(st, cfg, DT)
        diags.append(diag)
    return st, diags


def end_state_loss(st):
    """A smooth loss on the end state: positions and velocities weighed, so
    the gradient reaches both pressure solves."""
    act = st.active.to(st.position.dtype)
    w = torch.tensor([1.0, 2.0, -0.5], device=st.position.device)
    return torch.sum((torch.sum(st.position * w, -1) + 1e-3 * torch.sum(st.velocity**2, -1)) * act)


def mesh_loss(mesh):
    """A smooth function of the vertices of the valid triangles (independent
    of their order, so two meshes of one SDF give the same loss)."""
    v = mesh.vertices
    f = torch.sin(0.7 * v[..., 0] + 0.3 * v[..., 1] - 0.5 * v[..., 2])
    return torch.sum(f * mesh.valid.to(v.dtype)[:, None])


def compare_grads(what: str, g_dev: torch.Tensor, g_cpu: torch.Tensor, cos_min: float,
                  q_max: float) -> None:
    """Card against CPU: cosine similarity > `cos_min` and the 99.9th
    percentile of |difference| / max|g| below `q_max`. The maximum is
    printed, not held: a particle on a discontinuity (a skin push-out's
    switch, a marching-cubes case) may take the other branch on a one-ulp
    forward difference."""
    g_dev = g_dev.detach().cpu().flatten().double()
    g_cpu = g_cpu.detach().flatten().double()
    scale = float(torch.max(torch.abs(g_cpu)))
    diff = torch.abs(g_dev - g_cpu) / scale
    cos = float(torch.nn.functional.cosine_similarity(g_dev, g_cpu, dim=0))
    q = float(torch.quantile(diff, 0.999))
    log(f"gradient parity {what}: max|g| {scale:.4e}, cosine {cos:.8f} (> {cos_min}), relative "
        f"error max {float(diff.max()):.3e} / 99.9th percentile {q:.3e} (< {q_max})")
    check(scale > 0 and bool(torch.isfinite(g_dev).all()), f"{what}: gradient zero or non-finite")
    check(cos > cos_min, f"{what}: cosine similarity {cos} <= {cos_min}")
    check(q < q_max, f"{what}: 99.9th percentile of the relative error {q} >= {q_max}")


def grad_parity(device) -> None:
    """Gradients at 32^3, card (kernels, backward kernels) against CPU
    (plain versions and their autograd): the correction-off dam-break and
    the correction + obstacle + source scene through 2 substeps, then the
    scene's mesh on the 66^3 mesher grid.

    Bounds: correction off, the forward parity's size (the two agree to
    ~1e-6). The correction springs' Jacobian grows as 1/d^2 for close
    pairs, and marching cubes' as 1/(v_a - v_b)^2 on edges with close
    corner values, so there the forward differences of kernels E (2e-4
    cells) and F (6e-5 in the SDF) show up in the gradient: adding noise of
    that size to E's or F's output on the CPU moves the CPU gradient to
    cosine 0.995-0.996 and a 99.9th percentile of 4e-3 (springs) and 4e-2
    (mesh) of max|g|, so those two comparisons are held at 0.99 and 1e-2 /
    5e-2."""
    for what, make, cos_min, q_max in (
            ("32^3 dam-break, correction off",
             lambda dev: dam_break(32, dev, 1 << 15, correct=False), 0.99999, 1e-5),
            ("32^3 scene (correction, obstacle, source)", parity_scene, 0.99, 1e-2)):
        grads, ends = {}, {}
        for dev in (device, torch.device("cpu")):
            cfg, state = make(dev)
            vel = state.velocity.clone().requires_grad_()
            st, _ = rollout(state, cfg, vel)
            (grads[dev.type],) = torch.autograd.grad(end_state_loss(st), vel)
            ends[dev.type] = st
        compare_grads(f"{what}, d loss / d initial velocity", grads[device.type], grads["cpu"],
                      cos_min, q_max)

    # the mesher: both devices mesh the card's end positions of the scene
    pos = ends[device.type].position.detach()
    act = ends[device.type].active
    mgrads, counts = {}, {}
    for dev in (device, torch.device("cpu")):
        p = pos.to(dev).clone().requires_grad_()
        mesh = generate_mesh(p, act.to(dev), MESH_66)
        counts[dev.type] = int(mesh.count)
        (mgrads[dev.type],) = torch.autograd.grad(mesh_loss(mesh), p)
    log(f"mesh gradient 66^3: triangles gpu/cpu {counts[device.type]}/{counts['cpu']}")
    check(counts["cpu"] > 0 and abs(counts[device.type] - counts["cpu"]) <= 0.005 * counts["cpu"],
          "mesh gradient: triangle counts differ by more than 0.5 %")
    compare_grads("32^3 scene mesh (66^3), d loss / d position", mgrads[device.type],
                  mgrads["cpu"], 0.99, 5e-2)


def descent(cfg, state, steps: int, lr: float, what: str, n0: int):
    """`steps` steps of vel <- vel - lr * grad on the initial velocities.
    The loss is the summed squared distance of the active particles' end
    positions after 2 substeps from those of a run whose initial velocities
    are offset by GRAD_OFFSET. Substeps re-sort the particles, so the two
    sets are matched per axis in sorted order (the 1-D optimal matching).
    Returns the losses."""
    device = state.position.device
    cuda = device.type == "cuda"
    with torch.no_grad():
        off = torch.tensor(GRAD_OFFSET, device=device) * state.active[:, None]
        tgt, _ = rollout(state, cfg, state.velocity + off)
        target = torch.sort(tgt.position[tgt.active], dim=0).values
        del tgt
    vel = state.velocity.clone()
    losses = []
    for i in range(steps):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        pressure.ADJOINT_SOLVES.clear()
        v = vel.clone().requires_grad_()
        t0 = time.perf_counter()
        st, diags = rollout(state, cfg, v)
        loss = torch.sum((torch.sort(st.position[st.active], dim=0).values - target) ** 2)
        fwd_iters = [int(d.pressure_iterations) for d in diags]
        if cuda:
            torch.cuda.synchronize()
        fwd = time.perf_counter() - t0
        t0 = time.perf_counter()
        (g,) = torch.autograd.grad(loss, v)
        if cuda:
            torch.cuda.synchronize()
        bwd = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        for j, d in enumerate(diags):
            healthy(st, d, cfg, n0, f"{what} step {i} substep {j}")
        gnorm = float(torch.linalg.vector_norm(g))
        check(bool(torch.isfinite(g).all()) and gnorm > 0, f"{what} step {i}: gradient zero or non-finite")
        adj = [it for it, _ in pressure.ADJOINT_SOLVES]
        log(f"{what} step {i}: forward {fwd * 1e3:.1f} ms, backward {bwd * 1e3:.1f} ms, loss "
            f"{float(loss.detach()):.6e}, |grad| {gnorm:.6e}, CG iterations forward {fwd_iters} adjoint {adj}, "
            f"peak memory {peak / 2**30:.2f} GiB ({peak} B)")
        # the end positions see the pressure of every substep but the last
        check(len(adj) == len(diags) - 1 and all(a > 0 for a in adj),
              f"{what} step {i}: adjoint solves {adj}")
        losses.append(float(loss.detach()))
        with torch.no_grad():
            vel = vel - lr * g
        del st, diags, loss, g, v
    return losses


def descent_32(device) -> None:
    """3 steps at 32^3 (the learning rate tuned there): the loss falls."""
    cfg, state = dam_break(32, device, 1 << 15, correct=False)
    losses = descent(cfg, state, 3, GRAD_LR, "32^3 descent", int(particle_count(state)))
    check(losses[1] < losses[0] and losses[2] < losses[1], f"32^3 descent: loss did not fall {losses}")


def grad_run(device) -> None:
    """The gradient path: 3 descent steps on the 128^3 correction-off
    dam-break."""
    cfg, state = dam_break(128, device, 1 << 21, correct=False)
    descent(cfg, state, 3, GRAD_LR, "128^3 descent", int(particle_count(state)))


def flip_run(device) -> None:
    """2 substeps of the 128^3 dam-break with FLIP and the mg16 V-cycle."""
    cfg, state = dam_break(128, device, 1 << 21, correct=False)
    cfg = dataclasses.replace(cfg, scheme=TransferScheme.FLIP,
                              solver=SolverConfig(preconditioner_dtype="bfloat16"))
    n0 = int(particle_count(state))
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, diag = sim.substep(state, cfg, DT)
        torch.cuda.synchronize()
        healthy(state, diag, cfg, n0, f"FLIP mg16 substep {i}")
        log(f"128^3 FLIP + mg16 substep {i}: {(time.perf_counter() - t0) * 1e3:.1f} ms, CG "
            f"{int(diag.pressure_iterations)} it res {float(diag.pressure_residual):.2e}, vmax "
            f"{float(diag.max_velocity):.2f}, n {int(diag.particle_count)}")


def healthy(state, diag, cfg, n0: int, what: str) -> None:
    check(float(diag.pressure_residual) < 1e-5, f"{what}: CG residual {float(diag.pressure_residual)}")
    check(int(diag.pressure_iterations) < 200, f"{what}: CG iterations {int(diag.pressure_iterations)}")
    check(int(diag.particle_count) == n0, f"{what}: particle count {int(diag.particle_count)} != {n0}")
    for name in ("position", "velocity", "affine"):
        check(bool(torch.isfinite(getattr(state, name)).all()), f"{what}: non-finite {name}")
    pos = state.position[state.active]
    skin = cfg.boundary_skin_width
    lo = torch.tensor(cfg.domain_min, device=pos.device) + skin - 1e-4
    hi = torch.tensor(cfg.domain_max, device=pos.device) - skin + 1e-4
    check(bool(((pos >= lo) & (pos <= hi)).all()), f"{what}: particles outside [skin, domain - skin]")


def drive(name: str, fn, needed):
    """Run `fn` with the launch counts set to 0 just before it; fail unless
    every kernel in `needed` was launched. Returns (result, counts)."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    result = fn()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"launches on the {name}: {launches}")
    for k in needed:
        check(launches[k] > 0, f"kernel {k} was not launched on the {name}")
    return result, launches


def dam_break_run(device, correct: bool, substeps: int, with_step: bool) -> None:
    """The 128^3 dam-break: one warm-up substep, `substeps` timed ones and,
    if `with_step`, one CFL step(1/60); then, with correction, the mesh."""
    cfg, state = dam_break(128, device, 1 << 21, correct)
    what = "correction on" if correct else "correction off"
    n0 = int(particle_count(state))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    state, diag = sim.substep(state, cfg, DT)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    healthy(state, diag, cfg, n0, "warm-up substep")

    per = []
    for i in range(substeps):
        t0 = time.perf_counter()
        state, diag = sim.substep(state, cfg, DT)
        torch.cuda.synchronize()
        per.append((time.perf_counter() - t0) * 1e3)
        healthy(state, diag, cfg, n0, f"substep {i}")
        log(f"128^3 {what} substep {i}: {per[-1]:.1f} ms, CG {int(diag.pressure_iterations)} it "
            f"res {float(diag.pressure_residual):.2e}, vmax {float(diag.max_velocity):.2f}, "
            f"n {int(diag.particle_count)}, overflow {int(diag.overflow_count)}, "
            f"uncorrected {int(diag.correction_uncorrected)}")
    peak = torch.cuda.max_memory_allocated()
    log(f"128^3 APIC dam-break, {what}: {n0} particles, warm-up {warm * 1e3:.1f} ms, "
        f"{np.mean(per):.1f} ms/substep (mean of {substeps}; median {np.median(per):.1f}), "
        f"peak memory {peak / 2**30:.2f} GiB ({peak} B)")

    if with_step:
        t0 = time.perf_counter()
        state, sdiag = sim.step(state, cfg, 1.0 / 60.0)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        healthy(state, sdiag, cfg, n0, "CFL step")
        log(f"128^3 step(1/60): {int(sdiag.substeps)} substeps in {step_s * 1e3:.1f} ms, CG "
            f"{int(sdiag.pressure_iterations)} it res {float(sdiag.pressure_residual):.2e}, "
            f"vmax {float(sdiag.max_velocity):.2f}, max divergence {float(sdiag.max_divergence):.2e}, "
            f"uncorrected {int(sdiag.correction_uncorrected)}")

    if correct:
        t0 = time.perf_counter()
        mesh = generate_mesh(state.position, state.active, MESH_128)
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
        count = int(mesh.count)
        tris = mesh.vertices[:count]
        log(f"mesh {tuple(n + 1 for n in MESH_128.grid_size)} nodes: {count} triangles "
            f"(capacity {MESH_128.max_triangles}) in {mesh_s * 1e3:.1f} ms")
        check(0 < count < MESH_128.max_triangles, f"mesh: {count} triangles")
        check(bool(torch.isfinite(tris).all()), "mesh: non-finite vertices")


def testbed_run() -> None:
    """The testbed CLI: setup 4 for 2 frames, an OBJ every frame."""
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        rc = testbed_cli.main(["--setup", "4", "--frames", "2", "--mesh-every", "1", "--out", out])
        log(f"testbed setup 4, 2 frames: rc {rc}, {time.perf_counter() - t0:.2f} s")
        check(rc == 0, f"testbed exited with {rc}")
        for frame in range(2):
            pos, idx = load_obj(os.path.join(out, f"mesh_{frame:05d}.obj"))
            check(idx.shape[0] > 0 and bool(np.isfinite(pos).all()), f"testbed frame {frame} mesh")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.load()
    log(f"kernel build + load: {time.perf_counter() - t0:.1f} s ({_build.LIB_PATH.name})")

    cfg, state = dam_break(128, device, 1 << 21)
    state, _ = sim.substep(state, cfg, DT)
    stats = kernel_phases(cfg, state)
    stats.update(backward_kernel_phases(cfg, state))
    del state
    torch.cuda.empty_cache()

    slice_parity(device)
    scene_parity(device)
    grad_parity(device)
    descent_32(device)
    torch.cuda.empty_cache()
    _, launches = drive("main path (128^3, correction on, mesh)",
                        lambda: dam_break_run(device, True, 5, True), FORWARD_KERNELS)
    torch.cuda.empty_cache()
    drive("128^3 correction-off path", lambda: dam_break_run(device, False, 2, False),
          ("expand", "p2g", "stencil", "g2p"))
    torch.cuda.empty_cache()
    _, grad_launches = drive("128^3 gradient path", lambda: grad_run(device), GRAD_KERNELS)
    torch.cuda.empty_cache()
    _, flip_launches = drive("128^3 FLIP + mg16 path", lambda: flip_run(device),
                             ("expand", "p2g", "stencil", "stencil16"))
    torch.cuda.empty_cache()
    drive("testbed path (setup 4)", testbed_run, FORWARD_KERNELS)

    # launches: each kernel's count on the path it belongs to (the main path
    # for A-F, the gradient path for B' and D', the FLIP + mg16 path for the
    # bfloat16 stencil)
    launches.update(p2g_bwd=grad_launches["p2g_bwd"], g2p_bwd=grad_launches["g2p_bwd"],
                    stencil16=flip_launches["stencil16"])
    record = {"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name][0], replaces=KERNELS[name][1],
             launches=launches[name], **stats[name])
        for name in KERNELS
    ]}
    log(smi)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
