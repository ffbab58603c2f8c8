#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``libfluid_tpu_torch``) on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

Phases, one line of output each (or a few):

1. the card's name and power limit (nvidia-smi);
2. build of the CUDA kernels from ``libfluid_tpu_torch/csrc`` (one nvcc per
   source, in parallel, sm_90a); then the card's bfloat16 multiply, add and
   subtract and their paired forms against one rounding of the float32
   result over all 2^32 pairs of bfloat16 values (``csrc/bf16_check.cu``):
   the mismatches of each, 0 for every operation that mg16_pre and
   mg16_restrict use;
3. each kernel (A-F) against its plain PyTorch version on the card, at the
   shapes the 128^3 main path gives it (the state after one substep with
   position correction on, meshed on the 261^3-node grid), with error,
   median time of both and the least time the card could take (its bound);
   the fused V-cycle's four kernels each against its plain stage function
   at every level they run, with the device's own time of each and the
   route the coarse kernel took (its levels in shared or in device memory),
   and the whole fused cycle against the plain cycle, on the 128^3 levels
   and on the 50^3 levels of testbed setup 4 (float32 and bfloat16), with
   the times of the fused, the per-pass and the plain cycle and the
   launches of one cycle; the coarse kernel's two routes on the one level
   of two thin slabs (80 x 72 x 16 shared, 128 x 128 x 16 device); the
   four kernels and the cycle on a thin slab whose fine level runs
   mg(16)_pre and mg(16)_restrict (96 x 81 x 15: odd y and z, zero-padded
   by the restriction; its 48 x 41 x 8 bottom in shared memory in bfloat16,
   in device memory in float32), both dtypes; the
   host-clock ms of one V-cycle and one operator call, the kernels of a CG
   iteration; CG iterations of a substep with the fused and with the
   per-pass cycle; the same for the bfloat16 ("mg16") instance of the four
   kernels on the 128^3 levels (each equal to its plain stage, the cycle
   equal to the plain cycle) and the CG iterations of a FLIP + mg16 substep
   with the fused and with the per-pass bfloat16 cycle; kernel E also at 16
   and 32 slots a cell; kernels B and F also on grids no tile divides (B at
   5, 12 and 32 slots a cell, F with a support of 1, 2 and 4 cells and a
   crammed bin), two launches bit-equal; P2G's overflow merge and
   normalisation (p2g_overflow, p2g_normalize) against the plain merge at
   128^3 (the main path's window, and 4 slots a cell with windows of 4,096
   and 2^16 rows that the overflow rows fill), its gradient against the
   plain autograd, its host ms and the device operations, host copies and
   reads of one p2g_slots call and of one substep's p2g span, beside the
   plain path's;
   then the backward kernels B' (at 64^3: the plain autograd of P2G does
   not fit the card at 128^3; its time and bound also at 128^3; also on a
   grid no tile divides at 5, 12 and 32 slots a cell, APIC and PIC, two
   launches bit-equal) and D' (at 128^3) against the autograd of their
   plain versions; F's keep form (the forward of a mesh that wants a
   gradient: the values equal to F's, the node sums against the plain
   ones); E' and F' (one launch on the kept sums) against their plain closed
   forms at the main path's shapes (128^3 slot grid, 261^3 nodes), against
   the autograd of the plain versions on CPU copies in float64 and float32
   at 32^3 / 66^3 (the kernel's error against float64 no more than 4 x the
   float32 autograd's, cosine >= 0.9999), and away from those shapes (E' at
   16 and 32 slots a cell with coincident pairs and on an empty grid, F'
   with a support of 1, 2 and 4 cells and a crammed bin, bit-equal); and
   kernel C's bfloat16 instance against the
   plain bfloat16 stencil on every level and mode;
   kernels D and D' also on a 20 x 18 x 28 grid with a cell of 0.7
   (particles in random and in cell order, on faces, outside the domain, a
   count no block divides, none and one);
   a 128 x 64 x 8 dam-break, whose one multigrid level is too large for
   the one-block coarse kernel and takes its sweeps as stencil launches:
   the V-cycle against the plain cycle, three substeps against the CPU run;
   then the same with the mg16 preconditioner, whose sweeps there are the
   path that still launches kernel stencil16;
4. a seeded 32^3 dam-break with position correction off, and a 32^3 scene
   with the default options (position correction, a solid block, a
   source), each run for 2 substeps on the card (kernels) and on the CPU
   (plain versions) and compared; the second is then meshed, compared;
5. gradient parity, card against CPU, at 32^3: the gradient of a loss on
   the end state of 2 substeps with respect to the initial velocities, for
   both scenes of phase 4, and the gradient of a loss on the mesh vertices
   of the scene's end state (66^3 mesher grid) with respect to the
   positions, with every backward kernel launched (no plain version runs
   on the card); then 3 steps of gradient descent at 32^3, whose loss must
   fall;
6. the main path: the 128^3 APIC dam-break with position correction on
   (~2.0M particles), one warm-up substep, 5 timed substeps, one CFL
   ``step(1/60)``, then ``generate_mesh`` on the 260^3-cell mesher grid,
   with the healthy-output checks and the launch counts; then the stage
   split of a substep (a synchronize around each stage), ms per CG
   iteration beside phase 3's times of its kernels, one CG iteration's
   wall and device time split into the V-cycle's kernels, the operator,
   the vector and reduction ops and the idle time after the host read
   (torch.profiler), and the device's busy share of one substep;
7. the same dam-break with position correction off, 2 substeps;
8. the gradient paths: the 128^3 correction-off dam-break, 2 steps of
   gradient descent on the initial velocities through 2 unrolled substeps
   (forward and backward ms, loss, gradient norm, CG iterations of the
   forward and adjoint solves, peak memory); one such step with position
   correction on (kernel E'); the gradient of a loss on the mesh of the
   260^3-cell mesher grid with respect to the 2.0M positions (kernel F's
   keep form, then kernel F': one launch each, no second node pass), and
   the same mesh under no_grad (F alone);
9. the 128^3 dam-break with FLIP and the bfloat16 V-cycle ("mg16"), 3
   substeps, the stage split of 2 more and a profiled one (device busy),
   through the fused mg16_* kernels and no stencil16;
10. the testbed CLI, setup 4 (jet source + obstacle), 2 frames with an OBJ
    export every frame;
11. the renderer (no kernel of its own: PyTorch loops): BASELINE configs 1
    and 2 (Cornell and glass, 256^2 x 32 spp, the persistent tracer; wall
    time, rays cast, Mrays/s, host reads); both tracers against the golden
    images at 64^2 x 128 spp; config 3, the 64^3 simulate -> mesh -> render
    frame (substep, mesh, accelerator build and megakernel render ms); the
    accelerator on config 3's mesh and on the 128^3 main path's (~270k
    triangles) against the brute force on the card, build and traversal ms;
    one profiled Cornell render (device busy share); the CLI's ``--scene
    cornell1``; the bidirectional tracer as ``bench.py`` runs it (Cornell
    and glass, 256^2 x 32 spp, 6 + 6 bounces: wall time, rays cast, Mrays/s,
    host reads, the image mean against configs 1 and 2's) and through
    ``render`` against the golden images at 64^2 x 32 spp; the voxelizer on
    the 128^3 main path's and config 3's meshes (card against CPU); the
    testbed CLI rendering setup 0 (``--render-every 1``, 256^2, two PT
    frames at 4 spp and one BDPT frame at 1 spp: the split of a frame); the
    pixel gradient through a 16^3 substep, the mesher and the renderer,
    card against CPU (position correction off and on), and config 3's frame
    differentiably at full width (forward and backward ms, peak memory,
    |g|, a descent step);
12. the small harness: the DCC pipeline at setup 0's scale (3 frames, a
    mesh, a scrub back), a checkpoint of the 128^3 state restored and
    stepped beside the original, the native host library;
13. BASELINE config 5 (``bench.py:236-268``): the 256^3 tide, ~7.7M
    particles; two dense substeps (ms, peak memory), then ``substep_tiled``
    with 16 slabs from the first one's state, a warm-up and 3 timed
    substeps (ms, CG iterations, peak memory, the healthy-output checks),
    the tiled warm-up against the second dense substep row by row, and the
    launches of kernels A, B, E (16 a substep) and D;
14. the sharded paths on one rank (NCCL, world size 1, rendezvous on
    127.0.0.1): ``sharded_substep`` of the 128^3 main-path state (after one
    substep) against the dense substep as a particle multiset, ``step_z(1/60)``, and
    ``training_step`` at ``__graft_entry__.dryrun_multichip``'s scene scaled
    to config 3's 64^3 dam-break (64^2 x 1 spp, 16 sphere proxies): the
    loss finite, the gradient nonzero.

Phase 3 also holds kernels B, E and E' at 40 slots a cell and F and F' with
a support of 16 cells (where the slots take two words of an occupancy mask
and F's box of bin starts no longer fits shared memory).

Phase 3 also logs, beside each kernel's event median around its wrapper, the
device's own time of one launch (torch.profiler).

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
import socket
import subprocess
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from libfluid_tpu_torch import _bf16_check, _build, checkpoint, dcc, native, profiling, testbed, voxelizer
from libfluid_tpu_torch.config import CellType, MesherConfig, RenderConfig, SimConfig, SolverConfig, TransferScheme
from libfluid_tpu_torch import sim
from libfluid_tpu_torch.renderer import accel, bdpt, intersect, loops, pathtrace, scenes
from libfluid_tpu_torch.renderer.camera import Camera
from libfluid_tpu_torch.renderer.draws import HashDraws
from libfluid_tpu_torch.renderer.render import render
from libfluid_tpu_torch.renderer.scene import SceneBuilder, inject_mesh
from libfluid_tpu_torch.io.obj import load_obj
from libfluid_tpu_torch.mesher import generate_mesh, surface
from libfluid_tpu_torch.parallel import distributed as pdist
from libfluid_tpu_torch.parallel import shard as pshard
from libfluid_tpu_torch.parallel import zshard
from libfluid_tpu_torch.sim import (bigstep, binning, correction, kernels, multigrid, pressure,
                                    slotsort, sources, transfers)
from libfluid_tpu_torch.sim.state import make_generator, particle_count, set_solid
from libfluid_tpu_torch.testbed import __main__ as testbed_cli

# name -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "expand": ("libfluid_tpu_torch/csrc/expand.cu", "libfluid_tpu/sim/slotsort.py:78"),
    "p2g": ("libfluid_tpu_torch/csrc/p2g.cu", "libfluid_tpu/sim/kernels.py:58"),
    "stencil": ("libfluid_tpu_torch/csrc/stencil.cu", "libfluid_tpu/sim/multigrid.py:127"),
    # the fused float32 V-cycle
    "mg_pre": ("libfluid_tpu_torch/csrc/vcycle.cu", "libfluid_tpu/sim/multigrid.py:127"),
    "mg_restrict": ("libfluid_tpu_torch/csrc/vcycle.cu", "libfluid_tpu/sim/multigrid.py:127"),
    "mg_up": ("libfluid_tpu_torch/csrc/vcycle.cu", "libfluid_tpu/sim/multigrid.py:127"),
    "mg_coarse": ("libfluid_tpu_torch/csrc/vcycle.cu", "libfluid_tpu/sim/multigrid.py:127"),
    # its bfloat16 instance, the "mg16" cycle
    "mg16_pre": ("libfluid_tpu_torch/csrc/vcycle.cu", "libfluid_tpu/sim/multigrid.py:127"),
    "mg16_restrict": ("libfluid_tpu_torch/csrc/vcycle.cu", "libfluid_tpu/sim/multigrid.py:127"),
    "mg16_up": ("libfluid_tpu_torch/csrc/vcycle.cu", "libfluid_tpu/sim/multigrid.py:127"),
    "mg16_coarse": ("libfluid_tpu_torch/csrc/vcycle.cu", "libfluid_tpu/sim/multigrid.py:127"),
    "g2p": ("libfluid_tpu_torch/csrc/g2p.cu", "libfluid_tpu/sim/transfers.py:177,508"),
    "correction": ("libfluid_tpu_torch/csrc/correction.cu", "libfluid_tpu/sim/kernels.py:284"),
    "surface": ("libfluid_tpu_torch/csrc/surface.cu", "libfluid_tpu/mesher/surface.py:164"),
    # the backward kernels and kernel C's bfloat16 instance
    "p2g_bwd": ("libfluid_tpu_torch/csrc/p2g_bwd.cu", "libfluid_tpu/sim/kernels.py:58"),
    "g2p_bwd": ("libfluid_tpu_torch/csrc/g2p_bwd.cu", "libfluid_tpu/sim/transfers.py:177,508"),
    "stencil16": ("libfluid_tpu_torch/csrc/stencil.cu", "libfluid_tpu/sim/multigrid.py:127"),
    "correction_bwd": ("libfluid_tpu_torch/csrc/correction_bwd.cu", "libfluid_tpu/sim/kernels.py:284"),
    "surface_keep": ("libfluid_tpu_torch/csrc/surface.cu", "libfluid_tpu/mesher/surface.py:164"),
    "surface_bwd": ("libfluid_tpu_torch/csrc/surface_bwd.cu", "libfluid_tpu/mesher/surface.py:164"),
}
VCYCLE_KERNELS = ("mg_pre", "mg_restrict", "mg_up", "mg_coarse")
VCYCLE16_KERNELS = ("mg16_pre", "mg16_restrict", "mg16_up", "mg16_coarse")
FORWARD_KERNELS = ("expand", "p2g", "p2g_overflow", "p2g_normalize", "stencil", *VCYCLE_KERNELS, "g2p",
                   "correction", "surface")
GRAD_KERNELS = ("expand", "p2g", "p2g_bwd", "stencil", *VCYCLE_KERNELS, "g2p", "g2p_bwd")
# the mesh gradient's kernels: F in the form that keeps the node sums, then F'
MESH_GRAD_KERNELS = ("surface_keep", "surface_bwd")
BACKWARD_KERNELS = ("p2g_bwd", "g2p_bwd", "correction_bwd", *MESH_GRAD_KERNELS)
# Kernel F' against float64: the largest error of either float32 version sits
# on a node that one far particle reaches (its words carry 1 / W, W the cube
# of a kl of a few roundings) and varies severalfold with the order of the
# sums, so "4 x the plain version's" is held above this share of the largest
# component only
F_FLOOR = 1e-4
# kernel F' is held at its maximum on the nodes with a weight W above THIN_W
# whose average lies more than FLAT_DIFF cells from them, elsewhere by its bulk
THIN_W = 1e-3
FLAT_DIFF = 0.02
# the card's published peaks (H100 SXM): device memory and float32 outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved_bytes: float, flops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move (each input read once, each output written once)
    over the memory rate and its float32 operations over the peak rate.
    No kernel here has one PyTorch call that computes the same function
    (A's gather needs a mask as well, C's operator has per-face
    coefficients, B-F are particle-grid sums), so library_ms is null."""
    by_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops else "operations",
                library_ms=None)


def wall_ms(fn, reps: int = 20) -> float:
    """Host-clock ms per call of `fn` over `reps` calls ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def vcycle_phases(levels, what: str):
    """The fused V-cycle's kernels on `levels`, in the hierarchy's dtype: each
    against its plain stage function on the inputs the plain cycle gives
    that stage (float32: rtol 1e-6 / atol 1e-5; bfloat16, "mg16_*": equal),
    with the device's own time of each kernel at every level it runs, the
    coarse kernel on its own with the route it took (its levels in shared
    memory or in device memory), then the whole cycle against the plain one
    (float32: 1e-5 max|b|; bfloat16: equal) and beside the per-pass cycle,
    with times and the launches of one cycle. Returns the record of each
    kernel at its first (largest) level, and the host-clock ms of one fused
    cycle."""
    dev = levels[0].fluid.device
    dtype = levels[0].fluid.dtype
    prefix = multigrid._VCYCLE[dtype]
    exact = dtype == torch.bfloat16
    names = [f"{prefix}_{stage}" for stage in ("pre", "restrict", "up", "coarse")]
    held = "equal" if exact else "within rtol 1e-6/atol 1e-5"

    def holds(got, want):
        return torch.equal(got, want) if exact else close(got, want, 1e-6, 1e-5)

    gen = torch.Generator(device=dev).manual_seed(2)
    b = (20.0 * torch.randn(levels[0].fluid.shape, generator=gen, device=dev)).to(dtype) * levels[0].fluid
    first = multigrid.first_coarse_level(levels)
    shapes = [tuple(lv.fluid.shape) for lv in levels]
    out, bs = {}, [b]
    for l in range(first):
        lv, lc, bl = levels[l], levels[l + 1], bs[l]
        xw = multigrid._pre_torch(lv, bl)
        rcw = multigrid._restrict_residual_torch(lv, lc, xw, bl)
        ec = multigrid._coarse_torch(levels, rcw, l + 1)
        upw = multigrid._up_torch(lv, xw, ec, bl)
        bs.append(rcw)
        stages = {
            names[0]: (lambda: multigrid.pre_smooth(lv, bl), lambda: multigrid._pre_torch(lv, bl), xw,
                       bound(nbytes(bl, xw, *multigrid._level_args(lv)), 40.0 * bl.numel())),
            names[1]: (lambda: multigrid.restrict_residual(lv, lc, xw, bl),
                       lambda: multigrid._restrict_residual_torch(lv, lc, xw, bl), rcw,
                       # the residual reads no inv_diag
                       bound(nbytes(xw, bl, lv.diag, lv.fluid, lv.couple_u, lv.couple_v, lv.couple_w,
                                    lc.fluid, rcw), 40.0 * bl.numel())),
            names[2]: (lambda: multigrid.prolong_smooth(lv, xw, ec, bl),
                       lambda: multigrid._up_torch(lv, xw, ec, bl), upw,
                       bound(nbytes(xw, ec, bl, upw, *multigrid._level_args(lv)), 60.0 * bl.numel())),
        }
        for name, (fused, plain, want, bnd) in stages.items():
            got = fused()
            err = max_err(got, want)
            check(holds(got, want), f"{name} at {shapes[l]} ({what}) error {err}")
            rec = dict(max_abs_err=err, ms=median_ms(fused), plain_ms=median_ms(plain), **bnd)
            # one name a stage for both instances: mg_pre_kernel, mg_pre_march, ...
            kernel = name.replace(prefix, "mg")
            log(f"kernel {name} ({what}) level {shapes[l]}: {held}, {rec}; device time "
                f"{device_ms(fused, kernel)} (torch.profiler)")
            out.setdefault(name, rec)
    bc = bs[first]
    lows = levels[first:]
    got = multigrid.coarse_cycle(levels, bc, first)
    want = multigrid._coarse_torch(levels, bc, first)
    err = max_err(got, want)
    check(holds(got, want), f"{names[3]} from {shapes[first]} ({what}) error {err}")
    out[names[3]] = dict(
        max_abs_err=err, ms=median_ms(lambda: multigrid.coarse_cycle(levels, bc, first)),
        plain_ms=median_ms(lambda: multigrid._coarse_torch(levels, bc, first)),
        **bound(nbytes(bc, got, *(a for lv in lows for a in multigrid._level_args(lv))),
                40.0 * sum(lv.fluid.numel() for lv in lows) * 6))
    route = multigrid.coarse_route([lv.fluid.numel() for lv in lows], dtype)
    log(f"kernel {names[3]} ({what}) levels {shapes[first:]}, route {route}: {held} (max "
        f"{float(want.abs().max()):.3e}), {out[names[3]]}; device time "
        f"{device_ms(lambda: multigrid.coarse_cycle(levels, bc, first), 'mg_coarse_kernel')} (torch.profiler)")

    torch.cuda.synchronize()
    kernels.reset_launches()
    got = multigrid.v_cycle(levels, b)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    want = multigrid._coarse_torch(levels, b, 0)
    err, tol = max_err(got, want), 0.0 if exact else 1e-5 * float(b.abs().max())
    check(torch.equal(got, want) if exact else err <= tol,
          f"fused V-cycle ({what}) differs from the plain cycle by {err} > {tol}")
    check(set(launches) <= set(names) and sum(launches.values()) <= 10,
          f"fused V-cycle ({what}) launched {launches}")
    err_pp = max_err(got, multigrid.v_cycle_per_pass(levels, b))
    cyc = bound(nbytes(b, got, *(a for lv in levels for a in multigrid._level_args(lv))))
    fused_wall = wall_ms(lambda: multigrid.v_cycle(levels, b))
    log(f"V-cycle ({what}) levels {shapes}: fused against plain max abs error {err:.3e} ("
        f"{'equal' if exact else f'<= 1e-5 max|b| = {tol:.3e}'}), against per-pass {err_pp:.3e}; "
        f"{sum(launches.values())} launches a cycle {launches}; "
        f"device ms fused {median_ms(lambda: multigrid.v_cycle(levels, b)):.4f}, per-pass "
        f"{median_ms(lambda: multigrid.v_cycle_per_pass(levels, b)):.4f}, plain "
        f"{median_ms(lambda: multigrid._coarse_torch(levels, b, 0), PLAIN_REPS_SLOW):.4f}; wall ms fused "
        f"{fused_wall:.4f}, per-pass "
        f"{wall_ms(lambda: multigrid.v_cycle_per_pass(levels, b), 5):.4f}; bound {cyc['bound_ms']:.4f} ms "
        f"({cyc['bound_by']})")
    return out, fused_wall


def slab_types(shape, gen):
    """Cell types of a thin slab: a solid floor, fluid at random in the
    lower two thirds, air above."""
    device = gen.device
    ct = torch.full(shape, CellType.AIR, dtype=torch.int8, device=device)
    ct[:, 0, :] = CellType.SOLID
    fluid = torch.rand(shape, generator=gen, device=device) < 0.7
    fluid[:, 2 * shape[1] // 3:, :] = False
    ct[fluid & (ct == CellType.AIR)] = CellType.FLUID
    return ct


def coarse_routes(device) -> None:
    """The coarse kernel on the last level of a thin slab, in both dtypes:
    80 x 72 x 16 ends in one level of 11,520 cells, which stays in shared
    memory; 128 x 128 x 16 in one of 32,768 cells, the most one block takes,
    which runs in device memory. Each against its plain sub-cycle (float32:
    rtol 1e-6 / atol 1e-5; bfloat16: equal), with its route and device
    time."""
    gen = torch.Generator(device=device).manual_seed(4)
    for shape, route in (((80, 72, 16), "shared"), ((128, 128, 16), "device")):
        ct = slab_types(shape, gen)
        for levels in (multigrid.build_levels(ct), bf16_levels(multigrid.build_levels(ct))):
            dtype = levels[0].fluid.dtype
            first = multigrid.first_coarse_level(levels)
            cells = [lv.fluid.numel() for lv in levels[first:]]
            check(first == len(levels) - 1 and multigrid.coarse_route(cells, dtype) == route,
                  f"{shape}: levels of {cells} cells from level {first} do not take route {route}")
            b = (20.0 * torch.randn(levels[first].fluid.shape, generator=gen, device=device)).to(dtype)
            b = b * levels[first].fluid
            got = multigrid.coarse_cycle(levels, b, first)
            want = multigrid._coarse_torch(levels, b, first)
            exact = dtype == torch.bfloat16
            check(torch.equal(got, want) if exact else close(got, want, 1e-6, 1e-5),
                  f"mg_coarse route {route} on {shape} ({dtype}) error {max_err(got, want)}")
            log(f"kernel {multigrid._VCYCLE[dtype]}_coarse, route {route}, one level "
                f"{tuple(levels[first].fluid.shape)} of a {shape} slab ({dtype}): "
                f"{'equal' if exact else f'max abs error {max_err(got, want):.3e}'}; device time "
                f"{device_ms(lambda: multigrid.coarse_cycle(levels, b, first), 'mg_coarse_kernel')} "
                f"(torch.profiler)")


def slab_cycle(device) -> None:
    """The fused cycle on a thin slab whose fine level runs mg(16)_pre and
    mg(16)_restrict: 96 x 81 x 15 (odd y and z, which the restriction pads
    with zeros) over a 48 x 41 x 8 bottom, each kernel against its plain
    stage with its device time, in float32 and bfloat16."""
    gen = torch.Generator(device=device).manual_seed(5)
    shape = (96, 81, 15)
    levels = multigrid.build_levels(slab_types(shape, gen))
    check(len(levels) == 2 and multigrid.first_coarse_level(levels) == 1,
          f"the {shape} slab's hierarchy {[tuple(lv.fluid.shape) for lv in levels]} does not run the fine "
          "kernels")
    vcycle_phases(levels, f"{shape} slab")
    vcycle_phases(bf16_levels(levels), f"{shape} slab, bfloat16")


def bf16_arithmetic(device) -> None:
    """The card's bfloat16 multiply, add and subtract (and their paired
    forms) against one rounding of the float32 result over all 2^32 pairs of
    bfloat16 values: fails on a mismatch in an operation that mg16_pre and
    mg16_restrict use."""
    _bf16_check.rounding_check(device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts = _bf16_check.rounding_check(device)
    torch.cuda.synchronize()
    log(f"bfloat16 arithmetic over all 2^32 pairs against one rounding of the float32 result: "
        f"mismatches {counts} ({(time.perf_counter() - t0) * 1e3:.1f} ms)")
    for op in _bf16_check.KERNEL_OPS:
        check(counts[op] == 0, f"the card's bfloat16 {op} differs from one rounding in {counts[op]} pairs")


def bf16_levels(levels):
    """The bfloat16 copy of a hierarchy that ``pressure._cg``'s mg16 branch
    makes."""
    return multigrid.Hierarchy(
        multigrid.MGLevel(*[f.to(torch.bfloat16) for f in lv[:-1]], lv.scale) for lv in levels)


def flip_mg16(cfg):
    """`cfg` with FLIP and the bfloat16 V-cycle ("mg16"), correction off:
    the FLIP + mg16 path's configuration."""
    return dataclasses.replace(cfg, scheme=TransferScheme.FLIP, enable_position_correction=False,
                               solver=SolverConfig(preconditioner_dtype="bfloat16"))


def cg_parity(state, cfg, what: str = "128^3") -> None:
    """One substep from `state` with the fused cycle and one with the
    per-pass cycle (in the dtype of `cfg`'s preconditioner): the same
    preconditioner gives the same CG iterations (within 1)."""
    runs = {}
    fused = multigrid.v_cycle
    for name, cycle in (("fused", fused), ("per-pass", multigrid.v_cycle_per_pass)):
        draws = state.generator.get_state()
        multigrid.v_cycle = cycle
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, diag = sim.substep(state, cfg, DT)
            torch.cuda.synchronize()
            runs[name] = ((time.perf_counter() - t0) * 1e3, int(diag.pressure_iterations),
                          float(diag.pressure_residual))
        finally:
            multigrid.v_cycle = fused
            state.generator.set_state(draws)
    log(f"CG parity on one {what} substep: " + ", ".join(
        f"{name} cycle {ms:.1f} ms, {it} iterations, residual {res:.2e}"
        for name, (ms, it, res) in runs.items()))
    check(abs(runs["fused"][1] - runs["per-pass"][1]) <= 1, f"CG iterations differ by more than 1: {runs}")
    check(runs["fused"][2] < 1e-5, f"CG residual with the fused cycle {runs['fused'][2]}")


def correction_many_slots(device) -> None:
    """Kernel E's shared memory grows with the slots a cell may hold, up to
    a word of 32 (186 KB a block; the main path has 12); above that it
    takes its own and its neighbours' slots a word at a time. 16, 32 and 40
    slots a cell on random slots of a small grid with an empty third,
    against the plain version, two launches bit-equal."""
    shape = (20, 18, 28)
    cfg = SimConfig(grid_size=shape, particle_capacity=8)
    gen = torch.Generator(device=device).manual_seed(5)
    cell = torch.stack(torch.meshgrid(
        *(torch.arange(n, device=device, dtype=torch.float32) for n in shape), indexing="ij"))
    errs = {}
    for kc in (16, 32, 40):
        mask = (torch.rand((kc, *shape), generator=gen, device=device) < 0.4).float()
        mask[..., : shape[2] // 3] = 0.0
        pos = (cell[:, None] + torch.rand((3, kc, *shape), generator=gen, device=device)) * mask
        got = kernels.correction_springs(pos, mask, 0.5, 99, (2, 0, 5))
        check(torch.equal(got, kernels.correction_springs(pos, mask, 0.5, 99, (2, 0, 5))),
              f"correction with {kc} slots a cell: two launches differ")
        want = correction._springs_torch(pos, mask, 0.5, 99, cfg, (2, 0, 5))
        errs[kc] = max_err(got, want) / (100.0 * float(torch.max(torch.abs(pos))))
        check(errs[kc] < 2e-6, f"correction with {kc} slots a cell: normalized error {errs[kc]} >= 2e-6")
    log(f"kernel correction, more slots a cell at {shape}: normalized error "
        + ", ".join(f"{e:.3e} with {kc} slots a cell" for kc, e in errs.items())
        + " (< 2e-6), two launches bit-equal")


def p2g_odd_shapes(device) -> None:
    """Kernel B away from the main path's shapes: a grid no tile divides,
    a cell size and offset that are not 1 and 0, 5, 12, 32 and 40 slots a
    cell (32 fills more than one shared-memory chunk, 40 takes two words of
    the occupancy mask), slots that are not
    prefix-dense, a third of the grid empty, one cell full, APIC and PIC;
    each against the plain version, and two launches bit-equal."""
    shape = (20, 18, 28)
    gen = torch.Generator(device=device).manual_seed(7)
    cell = torch.stack(torch.meshgrid(
        *(torch.arange(n, device=device, dtype=torch.float32) for n in shape), indexing="ij"))
    errs = {}
    for scheme in (TransferScheme.APIC, TransferScheme.PIC):
        for k in (5, 12, 32, 40):
            cfg = SimConfig(grid_size=shape, cell_size=0.7, grid_offset=(0.3, -0.2, 0.1),
                            scheme=scheme, max_neighbors_per_cell=k, particle_capacity=8)
            mask = (torch.rand((k, *shape), generator=gen, device=device) < 0.4).float()
            mask[..., : shape[2] // 3] = 0.0
            mask[:, 7, 5, 15] = 1.0
            off = torch.tensor(cfg.grid_offset, device=device).reshape(3, 1, 1, 1, 1)
            pos = (cell[:, None] + torch.rand((3, k, *shape), generator=gen, device=device)) * 0.7 + off
            rest = torch.randn((12, k, *shape), generator=gen, device=device)
            rest[3:] *= 0.2
            data = (torch.cat([pos, mask[None], rest]) * mask[None]).contiguous()
            kn, kd = kernels.p2g_faces(data, cfg)
            kn2, kd2 = kernels.p2g_faces(data, cfg)
            check(all(torch.equal(a, b) for a, b in zip((*kn, *kd), (*kn2, *kd2))),
                  f"p2g with {k} slots a cell, {scheme.name}: two launches differ")
            pn, pd = transfers._p2g_slots_torch(data, cfg)
            err = 0.0
            for a in range(3):
                po = transfers._normalize(pn[a], pd[a])
                err = max(err, max_err(transfers._normalize(kn[a], kd[a]), po)
                          / (float(torch.max(torch.abs(po))) + 1e-9))
            errs[f"{scheme.name} {k}"] = err
            check(err < 2e-5, f"p2g with {k} slots a cell, {scheme.name}: normalized error {err} >= 2e-5")
    log(f"kernel p2g, odd shapes at {shape}, cell 0.7: normalized error "
        + ", ".join(f"{e:.3e} ({what} slots a cell)" for what, e in errs.items())
        + " (< 2e-5), two launches bit-equal")


def plain_p2g_slots(slot_grid, position, velocity, affine, active, cfg, overflow_start):
    """``p2g_slots`` as it was before its two kernels: kernel B, then the
    plain overflow merge and normalisation (the CPU path's functions) on the
    card."""
    num, den = kernels.p2g_faces(slot_grid.data, cfg)
    idx = transfers._overflow_rows(slot_grid.overflow, position.shape[0], cfg, overflow_start)
    return transfers._merge_overflow(num, den, position, velocity, affine, active, idx, cfg)


def host_ms(fn, reps: int = 10) -> float:
    """Host-clock ms of one call of `fn` from a drained queue to its return
    (its enqueue and whatever it waits for inside), the mean of `reps`."""
    fn()
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / reps * 1e3


def profiled_ops(fn, span=None, seen="p2g_kernel", tries: int = 4) -> dict:
    """What one call of `fn` put on the card under torch.profiler, or only
    what it launched inside its first `span` (a ``profiling`` span, a
    user_annotation range of the trace): device operations by name, copies
    from the host, synchronizing runtime calls by name (the profiled call
    ends in one ``cudaDeviceSynchronize``) and host reads
    (``_local_scalar_dense``). The profiler now and then reports none of a
    window's device operations: the call is profiled again, up to `tries`
    times, until kernel `seen` (which `fn` launches once) is among them."""
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        lo, hi = -float("inf"), float("inf")
        if span is not None:
            (first, *_) = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                                 for e in events
                                 if e.get("cat") == "user_annotation" and e.get("name") == span)
            lo, hi = first
        inside = [e for e in events if e.get("ph") == "X" and lo <= float(e.get("ts", -1.0)) <= hi]
        runtime = [e for e in inside if e.get("cat") in ("cuda_runtime", "cuda_driver")]
        corr = {e["args"]["correlation"] for e in runtime if "correlation" in e.get("args", {})}
        ops = {}
        h2d = 0
        for e in events:
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and e.get("args", {}).get("correlation") in corr:
                name = e["name"]
                if e["cat"] == "kernel":  # the function's name, without its namespace's parentheses or arguments
                    name = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0][-48:]
                ops[name] = ops.get(name, 0) + 1
                h2d += e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]
        if seen in ops:
            break
    return dict(device_ops=sum(ops.values()), h2d_copies=h2d,
                syncs={name: sum(e["name"] == name for e in runtime)
                       for name in sorted({e["name"] for e in runtime if "Synchronize" in e["name"]})},
                host_reads=sum(e.get("cat") == "cpu_op" and e["name"] == "aten::_local_scalar_dense"
                               for e in inside),
                by_name=dict(sorted(ops.items(), key=lambda kv: -kv[1])))


def p2g_overflow_parity(cfg, state) -> None:
    """Kernels p2g_overflow and p2g_normalize (``kernels.p2g_overflow``, the
    path of ``transfers.p2g_slots`` on the card) against the plain overflow
    merge and normalisation on the card, at 128^3 from `state`: the main
    path's slot capacity and window (4,096 rows), and 4 slots a cell with a
    window of 4,096 and of 2^16 rows, which the overflow rows fill; also the
    window given as rows (``overflow_start`` None). Then the gradient of a
    scalar loss on (u, v, w) with respect to kernel B's sums, the positions,
    velocities and affine matrices through the autograd Function against
    the plain merge's autograd; the host ms of ``p2g_slots`` on both paths;
    the device time of the two kernels against their bound; and the device
    operations, copies from the host, synchronizing calls and host reads of
    one ``p2g_slots`` call and of the ``p2g`` span of one profiled substep,
    on both paths, with the span's ``p2g_overflow.kernel`` and
    ``p2g_overflow.plain`` counts."""
    dev = state.position.device
    gen = torch.Generator(device=dev).manual_seed(11)
    for k, window in ((cfg.max_neighbors_per_cell, cfg.p2g_overflow_capacity), (4, 4096), (4, 1 << 16)):
        c = dataclasses.replace(cfg, max_neighbors_per_cell=k, p2g_overflow_capacity=window)
        sb = slotsort.sort_and_build(state, c)
        st = sb.state
        args = (sb.slot_grid, st.position, st.velocity, st.affine, st.active, c)
        n = st.position.shape[0]
        cap = transfers.overflow_window(c, n)
        n_over = int(sb.slot_grid.overflow.sum())
        want = plain_p2g_slots(*args, sb.n_kept)
        errs = {}
        for what, start in (("window", sb.n_kept), ("rows", None)):
            got = transfers.p2g_slots(*args, overflow_start=start)
            errs[what] = max(max_err(g, w) / (float(torch.max(torch.abs(w))) + 1e-9) for g, w in zip(got, want))
        check(max(errs.values()) < 2e-5, f"p2g_overflow at K {k}, window {cap}: normalized error {errs}")

        num, den = kernels.p2g_faces(sb.slot_grid.data, c)
        # a face whose weight is near the 1e-6 cut has a gradient ~ 1 / den^2,
        # which the order of the atomics in either version moves: the loss
        # weighs the faces of weight 0.01 and more
        weights = [torch.randn(s, generator=gen, device=dev) * (d > 0.01)
                   for s, d in zip(kernels.face_shapes(c), den)]
        idx = transfers._overflow_rows(sb.slot_grid.overflow, n, c, sb.n_kept)
        # velocities apart from their face's average, so that the positions'
        # gradient is not a cancellation down to rounding (the state's
        # velocities are all but uniform after one substep)
        vel = st.velocity + 10.0 * torch.randn(st.velocity.shape, generator=gen, device=dev)
        aff = st.affine + torch.randn(st.affine.shape, generator=gen, device=dev)

        def grads(fn):
            leaves = [t.detach().clone().requires_grad_() for t in (*num, *den, st.position, vel, aff)]
            loss = sum(torch.sum(o * w) for o, w in zip(fn(leaves), weights))
            return torch.autograd.grad(loss, leaves, allow_unused=True)

        g_k = grads(lambda l: kernels.p2g_overflow(l[:3], l[3:6], l[6], l[7], l[8], st.active,
                                                   sb.slot_grid.overflow, c, start=sb.n_kept))
        g_p = grads(lambda l: transfers._merge_overflow(l[:3], l[3:6], l[6], l[7], l[8], st.active, idx, c))
        g_errs = [max_err(a, b) / (float(torch.max(torch.abs(b))) + 1e-30) for a, b in zip(g_k, g_p)]
        check(max(g_errs) < 1e-5 and (n_over == 0 or all(torch.any(g != 0) for g in g_p[6:])),
              f"p2g_overflow gradient at K {k}, window {cap}: relative errors {g_errs}")
        del num, den, g_k, g_p
        log(f"kernels p2g_overflow + p2g_normalize at 128^3, K {k}, window {cap} rows from n_kept "
            f"{int(sb.n_kept)} of {n}, {n_over} overflow rows ({min(n_over, cap)} merged): normalized error "
            + ", ".join(f"{e:.3e} ({what})" for what, e in errs.items())
            + f" (< 2e-5); gradient against the plain autograd, relative error {max(g_errs):.3e} "
            f"(sums {max(g_errs[:6]):.3e}, position {g_errs[6]:.3e}, velocity {g_errs[7]:.3e}, "
            f"affine {g_errs[8]:.3e}; < 1e-5)")
        if k != cfg.max_neighbors_per_cell:
            continue
        # the main path's shapes: time, bound, launches
        kernel_path = lambda: transfers.p2g_slots(*args, overflow_start=sb.n_kept)  # noqa: E731
        plain_path = lambda: plain_p2g_slots(*args, sb.n_kept)  # noqa: E731
        faces = sum(w.numel() for w in weights)
        moved = cap * (4 * (3 + 3 + 9) + 2) + 4 * 3 * faces  # the window's rows; num, den read, u, v, w written
        b = bound(moved)
        log(f"p2g_slots at 128^3 (K {k}): host ms {host_ms(kernel_path):.3f} with the kernels, "
            f"{host_ms(plain_path):.3f} on the plain path; wall ms {wall_ms(kernel_path):.3f} / "
            f"{wall_ms(plain_path):.3f}; device time p2g_overflow {device_ms(kernel_path, 'p2g_overflow_kernel')}, "
            f"p2g_normalize {device_ms(kernel_path, 'p2g_normalize_kernel')} (torch.profiler); bound of the two "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {moved / 1e6:.1f} MB)")
        alone = {what: profiled_ops(fn) for what, fn in (("the kernels", kernel_path), ("the plain path", plain_path))}
        for what, ops in alone.items():
            log(f"one p2g_slots call on {what}: {ops}")
        ops = alone["the kernels"]
        mine = ("p2g_kernel", "p2g_overflow_kernel", "p2g_normalize_kernel")
        check(all(ops["by_name"].get(name, 0) == 1 for name in mine) and ops["device_ops"] <= len(mine) + 5
              and ops["h2d_copies"] == 0 and ops["host_reads"] == 0,
              f"p2g_slots on the card launched more than B, the two kernels and 5 others, or copied or read: {ops}")
    spans = {}
    step_p2g = transfers.p2g_slots
    for what in ("the kernels", "the plain path"):
        if what == "the plain path":
            transfers.p2g_slots = lambda sg, p, v, a, act, c, overflow_start=None: plain_p2g_slots(
                sg, p, v, a, act, c, overflow_start)
        profiling.clear()
        try:
            spans[what] = profiled_ops(lambda: sim.substep(state, cfg, DT), span="p2g")
        finally:
            transfers.p2g_slots = step_p2g
        spans[what]["counters"] = {key: sum(f.total(key) for f in profiling.frames())
                                   for key in ("p2g_overflow.kernel", "p2g_overflow.plain")}
        profiling.clear()
        log(f"the p2g span of one profiled 128^3 substep on {what}: {spans[what]}")
    mine = spans["the kernels"]
    check(mine["device_ops"] <= 30 and mine["h2d_copies"] == 0
          and mine["counters"] == {"p2g_overflow.kernel": 1, "p2g_overflow.plain": 0},
          f"the p2g span launched more than 30 device operations, copied from the host or took the "
          f"plain merge: {mine}")


def g2p_odd_shapes(device) -> None:
    """Kernels D and D' away from the main path's shapes: a grid no block
    divides evenly, a cell size and offset that are not 1 and 0, particles
    in random order and in cell order (the order the substep gives them),
    some exactly on faces, some up to 0.4 cells outside the domain, a count
    that is no multiple of the block, none and one; D against the plain
    version (rtol/atol 1e-5), D' against the plain version's autograd (faces
    within 1e-4 of the largest face cotangent, positions within 1e-5 of the
    largest position cotangent, as at 128^3). The plain version runs on CPU
    copies here: a kernel divides by the cell size as the CPU does, while
    PyTorch on the card multiplies by its reciprocal, and with a cell of 0.7
    a particle on a face then falls into the other cell, where the affine
    rows (the gradient of a piecewise trilinear field) jump."""
    shape, h = (20, 18, 28), 0.7
    cfg = SimConfig(grid_size=shape, cell_size=h, grid_offset=(0.3, -0.2, 0.1), particle_capacity=8)
    gen = torch.Generator(device=device).manual_seed(13)
    off = torch.tensor(cfg.grid_offset, device=device)
    dims = torch.tensor(shape, device=device, dtype=torch.float32)
    u, v, w = (torch.randn(sh, generator=gen, device=device) for sh in kernels.face_shapes(cfg))
    grid = sim.new_state(cfg, device).grid._replace(u=u, v=v, w=w)
    n = 40_003
    pos = off + (torch.rand((n, 3), generator=gen, device=device) * (dims + 0.8) - 0.4) * h
    on_faces = torch.floor(torch.rand((512, 3), generator=gen, device=device) * (dims + 1.0))
    pos[:512] = off + on_faces * h
    cell = torch.clamp(torch.floor((pos - off) / h), min=0).int()
    order = torch.argsort((cell[:, 0] * shape[1] + cell[:, 1]) * shape[2] + cell[:, 2], stable=True)
    errs = {}
    cpu = [t.cpu() for t in (u, v, w)]
    for what, p in (("random order", pos), ("cell order", pos[order].contiguous()),
                    ("no particle", pos[:0]), ("one particle", pos[7:8].contiguous())):
        vk, ak = transfers.g2p_pic(grid, p, cfg)
        gv = torch.randn(vk.shape, generator=gen, device=device)
        ga = torch.randn(ak.shape, generator=gen, device=device)
        got = transfers.g2p_bwd(u, v, w, p, gv, ga, cfg)
        leaves = [t.requires_grad_() for t in (*cpu, p.cpu())]
        vp, ap = transfers._g2p_plain(*leaves, cfg)
        want = [g.to(device) for g in torch.autograd.grad((vp, ap), leaves, (gv.cpu(), ga.cpu()))]
        vp, ap = vp.detach().to(device), ap.detach().to(device)
        check(vk.shape == vp.shape and ak.shape == ap.shape, f"g2p, {what}: shapes")
        if p.shape[0] == 0:
            check(all(not bool(g.any()) for g in got), "g2p_bwd, no particle: a cotangent is not zero")
            continue
        check(close(vk, vp, 1e-5, 1e-5) and close(ak, ap, 1e-5, 1e-5),
              f"g2p, {what}: error velocity {max_err(vk, vp)} affine {max_err(ak, ap)}")
        rels = [max_err(a, b) / float(torch.max(torch.abs(b))) for a, b in zip(got, want)]
        check(max(rels[:3]) < 1e-4 and rels[3] < 1e-5, f"g2p_bwd, {what}: relative errors {rels}")
        errs[what] = (max(max_err(vk, vp), max_err(ak, ap)), max(rels[:3]), rels[3])
    log(f"kernels g2p and g2p_bwd, odd shapes at {shape}, cell {h}, {n} particles: "
        + ", ".join(f"{what}: D max abs error {d:.3e}, D' relative error faces {f:.3e} position {q:.3e}"
                    for what, (d, f, q) in errs.items())
        + " (D rtol/atol 1e-5; D' faces < 1e-4, position < 1e-5); none and one particle too")


def surface_odd_shapes(device) -> None:
    """Kernel F away from the main path's shapes: a node grid no tile
    divides, a support of 1, 2 and 4 cells, inactive particles, particles
    outside the grid within and beyond the padding, one bin of 5,000
    particles (more than one shared-memory chunk), half the grid empty; each
    against the plain version, and two launches bit-equal."""
    grid, h, origin = (37, 30, 45), 0.5, (-1.0, 0.5, 0.25)
    gen = torch.Generator(device=device).manual_seed(11)
    lo = torch.tensor(origin, device=device)
    size = torch.tensor(grid, device=device) * h
    fluid = lo + torch.rand((200_000, 3), generator=gen, device=device) * size * torch.tensor(
        [0.5, 1.0, 1.0], device=device)
    # around the fluid's half of the grid, up to 3 units outside it
    around = lo - 3.0 + torch.rand((20_000, 3), generator=gen, device=device) * (
        size * torch.tensor([0.5, 1.0, 1.0], device=device) + 6.0)
    crammed = lo + (torch.tensor([5.0, 17.0, 30.0], device=device)
                    + torch.rand((5_000, 3), generator=gen, device=device)) * h
    pos = torch.cat([fluid, around, crammed]).contiguous()
    act = torch.arange(pos.shape[0], device=device) % 7 != 0
    errs = {}
    for extent in (0.5, 1.0, 2.0):
        cfg = MesherConfig(grid_size=grid, cell_size=h, grid_offset=origin, particle_extent=extent,
                           particle_radius=extent / 4.0)
        got = surface.sample_surface(pos, act, cfg)
        check(torch.equal(got, surface.sample_surface(pos, act, cfg)),
              f"surface with extent {extent}: two launches differ")
        want = surface._sample_surface_torch(pos, act, cfg)
        errs[extent] = max_err(got, want)
        check(errs[extent] < 2e-3, f"surface with extent {extent}: max abs error {errs[extent]} >= 2e-3")
        check(bool((want < 0).any()) and bool((want == 1.0).any()),
              f"surface with extent {extent}: no node inside the fluid, or none away from it")
    log(f"kernel surface, odd shapes at {tuple(n + 1 for n in grid)} nodes from {pos.shape[0]} "
        f"particles: max abs error "
        + ", ".join(f"{e:.3e} (support {round(x / h)} cells)" for x, e in errs.items())
        + " (< 2e-3), two launches bit-equal")


def surface_wide_support(device) -> None:
    """Kernels F and F' with a support of 16 cells (extent 2.0, cell
    0.125), where the box's bin starts no longer fit a block's shared
    memory and F takes the box's rows in runs: a node grid no tile divides,
    half of it empty, inactive particles, one bin of 3,700 particles (more
    than one chunk). F against the plain version (< 2e-3); F' at its maximum
    on the sound nodes against the plain closed form (< 1e-4 of the largest
    component, see :func:`held_on_sound_nodes`); both two launches
    bit-equal, an inactive particle's cotangent 0."""
    grid, h, origin = (40, 36, 44), 0.125, (-0.5, 0.25, 0.0)
    mcfg = MesherConfig(grid_size=grid, cell_size=h, grid_offset=origin, particle_extent=2.0,
                        particle_radius=0.5)
    check(surface._support_cells(mcfg) == 16, "the support is not 16 cells")
    gen = torch.Generator(device=device).manual_seed(19)
    lo = torch.tensor(origin, device=device)
    size = torch.tensor(grid, device=device) * h * torch.tensor([0.5, 1.0, 1.0], device=device)
    fluid = lo + torch.rand((1_500, 3), generator=gen, device=device) * size
    crammed = lo + (torch.tensor([9.0, 17.0, 30.0], device=device)
                    + torch.rand((3_700, 3), generator=gen, device=device)) * h
    pos = torch.cat([fluid, crammed]).contiguous()
    act = torch.arange(pos.shape[0], device=device) % 7 != 0
    got = surface.sample_surface(pos, act, mcfg)
    check(torch.equal(got, surface.sample_surface(pos, act, mcfg)), "surface, support 16: two launches differ")
    want = surface._sample_surface_torch(pos, act, mcfg)
    err = max_err(got, want)
    check(err < 2e-3, f"surface, support 16: max abs error {err} >= 2e-3")
    check(bool((want < 0).any()) and bool((want == 1.0).any()),
          "surface, support 16: no node inside the fluid, or none away from it")
    g = torch.randn(tuple(n + 1 for n in grid), generator=gen, device=device)
    binned, sums = kept_sums(pos, act, mcfg)
    dp = surface.sample_surface_bwd(binned, sums, g, mcfg)
    check(torch.equal(dp, surface.sample_surface_bwd(binned, sums, g, mcfg)),
          "surface_bwd, support 16: two launches differ")
    check(not bool(dp[~act].any()), "surface_bwd, support 16: an inactive particle got a cotangent")
    check(bool(dp.any()), "surface_bwd, support 16: no particle got a cotangent")
    log(f"kernels surface and surface_bwd, support 16 cells at {tuple(n + 1 for n in grid)} nodes (cell {h}) "
        f"from {pos.shape[0]} particles: F max abs error {err:.3e} (< 2e-3); F' "
        + held_on_sound_nodes("support 16 cells", pos, act, g, mcfg, False)
        + "; two launches bit-equal each")


def device_ms(fn, kernel: str, reps: int = 5) -> str:
    """The device's own time for one launch of the CUDA kernel whose name
    contains `kernel`, from torch.profiler over `reps` calls of `fn` (an
    event median around a wrapper carries the launch path and whatever
    else the wrapper runs), as text. The profiler now and then misses
    launches of a window, or reports them twice: the median is over the
    launches it reported, in windows of `reps`, 4 x and 16 x `reps` calls
    until one reports the kernel, and "not measured" (with the device
    items it did report) if none did."""
    fn()
    seen = set()
    for calls in (reps, 4 * reps, 16 * reps):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        times = [e.device_time_total for e in on_device if kernel in e.name]
        if times:
            return f"{float(np.median(times)) / 1e3:.4f} ms ({len(times)} launches of {calls} calls)"
        seen.update(e.name[:60] for e in on_device)
    return f"not measured (the profiler reported {sorted(seen)[:6]})"


def device_or_event_ms(fn, kernel: str, alone) -> str:
    """:func:`device_ms` of `fn`; where the profiler reports no launch of
    `kernel`, also the CUDA-event median around `alone`, a call that
    launches that kernel and nothing else (its outputs allocated once)."""
    text = device_ms(fn, kernel)
    if text.startswith("not measured"):
        text += f"; the CUDA-event median around the kernel alone {median_ms(alone):.4f} ms"
    return text


def kernel_phases(cfg, state):
    """Each kernel against its plain version at the main path's shapes.
    Returns the kernels' records and the host-clock ms of the two parts of a
    128^3 CG iteration that are kernels: (fused V-cycle, operator)."""
    out = {}

    rs = slotsort.sort_rank_major(state, cfg)
    got = slotsort.expand(rs.payT, rs.ins, rs.counts)
    want = slotsort._expand_torch(rs.payT, rs.ins, rs.counts)
    check(torch.equal(got, want), "expand kernel differs from its plain version")
    k_slots = cfg.max_neighbors_per_cell
    valid = int(torch.clamp(rs.counts, max=k_slots).sum())  # slots that read a payload row
    out["expand"] = dict(
        **bound(nbytes(got, rs.ins, rs.counts) + 16 * 4 * valid),
        max_abs_err=max_err(got, want),
        ms=median_ms(lambda: slotsort.expand(rs.payT, rs.ins, rs.counts)),
        plain_ms=median_ms(lambda: slotsort._expand_torch(rs.payT, rs.ins, rs.counts)),
    )
    log(f"kernel expand: exact, shape {tuple(got.shape)}, {out['expand']}; device time "
        f"{device_ms(lambda: slotsort.expand(rs.payT, rs.ins, rs.counts), 'expand_kernel')} (torch.profiler)")

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
    faces_b = nbytes(*kn, *kd)
    del kn, kd, pn, pd
    occ = int((data[3] != 0).sum())
    # the mask row of every slot, the other 15 rows of the occupied ones; a
    # slot reaches at most 54 faces, ~12 operations each
    out["p2g"] = dict(
        **bound(data[3].numel() * 4 + 15 * 4 * occ + faces_b, 54 * 12.0 * occ),
        max_abs_err=max(abs_errs),
        ms=median_ms(lambda: kernels.p2g_faces(data, cfg)),
        plain_ms=median_ms(lambda: transfers._p2g_slots_torch(data, cfg)),
    )
    log(f"kernel p2g: normalized error {max(errs):.3e} (< 2e-5), {out['p2g']}; device time "
        f"{device_ms(lambda: kernels.p2g_faces(data, cfg), 'p2g_kernel')} (torch.profiler)")
    del data, rs
    p2g_odd_shapes(state.position.device)
    g2p_odd_shapes(state.position.device)

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
        **bound(nbytes(x, b, x, *multigrid._level_args(lvl)), 20.0 * x.numel()),
        max_abs_err=worst,
        ms=median_ms(lambda: multigrid.stencil(lvl, x, b, multigrid.MODE_JACOBI, 0.8)),
        plain_ms=median_ms(lambda: multigrid._stencil_torch(lvl, x, b, multigrid.MODE_JACOBI, 0.8)),
    )
    log(f"kernel stencil: {len(levels)} levels {[tuple(l.fluid.shape) for l in levels]} x 3 modes "
        f"within rtol 1e-6/atol 1e-5, time at {tuple(lvl.fluid.shape)} Jacobi mode, {out['stencil']}; "
        f"device time {device_ms(lambda: multigrid.stencil(lvl, x, b, multigrid.MODE_JACOBI, 0.8), 'stencil_kernel')}"
        f" (torch.profiler)")
    operator_wall = wall_ms(lambda: multigrid.apply_level(lvl, x))
    del lvl, x, b
    records, cycle_wall = vcycle_phases(levels, "128^3")
    out.update(records)
    log(f"a 128^3 CG iteration's kernels on the host clock: V-cycle {cycle_wall:.4f} ms, operator "
        f"(apply_level) {operator_wall:.4f} ms")
    del levels
    tcfg, tstate = testbed.build_setup(4)
    for _ in range(2):
        tstate, _ = sim.substep(tstate, tcfg, 0.005)
    levels50 = multigrid.build_levels(tstate.grid.cell_type)
    vcycle_phases(levels50, "50^3 testbed setup 4")
    vcycle_phases(bf16_levels(levels50), "50^3 testbed setup 4, bfloat16")
    del tstate, levels50
    coarse_routes(state.position.device)
    slab_cycle(state.position.device)
    cg_parity(state, cfg)
    # the mg16 cycle: its four kernels and the cycle on the 128^3 levels in
    # bfloat16, as pressure._cg copies them; CG parity on a FLIP + mg16
    # substep of the same state
    levels16 = bf16_levels(multigrid.build_levels(state.grid.cell_type))
    records16, _ = vcycle_phases(levels16, "128^3 bfloat16")
    out.update(records16)
    del levels16
    cg_parity(state, flip_mg16(cfg), "128^3 FLIP + mg16")

    grid, pos = state.grid, state.position
    vk, ak = transfers.g2p_pic(grid, pos, cfg)

    def plain():
        return transfers.g2p_from_table(transfers.build_g2p_table(grid, cfg), pos, cfg)

    vp, ap = plain()
    check(close(vk, vp, 1e-5, 1e-5) and close(ak, ap, 1e-5, 1e-5),
          f"g2p error velocity {max_err(vk, vp)} affine {max_err(ak, ap)}")
    n_act = int(state.active.sum())
    out["g2p"] = dict(
        **bound(nbytes(grid.u, grid.v, grid.w) + n_act * (12 + 12 + 36), 54 * 8.0 * n_act),
        max_abs_err=max(max_err(vk, vp), max_err(ak, ap)),
        ms=median_ms(lambda: transfers.g2p_pic(grid, pos, cfg)),
        plain_ms=median_ms(plain),
    )
    log(f"kernel g2p: {pos.shape[0]} particles within rtol/atol 1e-5, {out['g2p']}; device time "
        f"{device_ms(lambda: transfers.g2p_pic(grid, pos, cfg), 'g2p_kernel')} (torch.profiler)")
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
    occ = int((res_mask != 0).sum())
    per_cell = (res_mask != 0).sum(0, dtype=torch.float32)
    around = 27.0 * torch.nn.functional.avg_pool3d(per_cell[None, None], 3, 1, 1)[0, 0]
    pairs = float((per_cell * (around - 1.0)).sum())  # the pairs inside the grid, ~20 operations each
    out["correction"] = dict(
        **bound(nbytes(res_mask, got) + 12 * occ, 20.0 * pairs),
        max_abs_err=max_err(got, want),
        ms=median_ms(lambda: kernels.correction_springs(res_pos, res_mask, re2, seed)),
        plain_ms=median_ms(lambda: correction._springs_torch(res_pos, res_mask, re2, seed, cfg),
                           PLAIN_REPS_SLOW),
    )
    log(f"kernel correction: springs {tuple(got.shape)} of {occ} resident slots, {pairs:.4e} pairs, "
        f"normalized error {norm:.3e} (< 2e-6), plain timed over {PLAIN_REPS_SLOW} reps, "
        f"{out['correction']}; device time "
        f"{device_ms(lambda: kernels.correction_springs(res_pos, res_mask, re2, seed), 'correction_kernel')} "
        f"(torch.profiler)")
    del sb, res_pos, res_mask, got, want
    correction_many_slots(state.position.device)

    act = state.active
    got = surface.sample_surface(pos, act, MESH_128)
    want = surface._sample_surface_torch(pos, act, MESH_128)
    err = max_err(got, want)
    check(err < 2e-3, f"surface error {err} >= 2e-3")
    check(bool((want < 0).any()), "surface: no node inside the fluid")
    # a particle weighs on the nodes within its extent, ~21 operations a pair
    reach = 4.0 / 3.0 * np.pi * (MESH_128.particle_extent / MESH_128.cell_size) ** 3
    out["surface"] = dict(
        **bound(nbytes(got) + 12 * n_act, 21.0 * reach * n_act),
        max_abs_err=err,
        ms=median_ms(lambda: surface.sample_surface(pos, act, MESH_128)),
        plain_ms=median_ms(lambda: surface._sample_surface_torch(pos, act, MESH_128),
                           PLAIN_REPS_SLOW),
    )
    bin_ms = median_ms(lambda: surface.bin_particles(pos, act, MESH_128))
    log(f"kernel surface: {tuple(got.shape)} nodes from {int(act.sum())} particles, max abs "
        f"error {err:.3e} (< 2e-3); ms includes the CSR binning ({bin_ms:.3f} ms of it); plain timed over "
        f"{PLAIN_REPS_SLOW} reps, {out['surface']}; device time of the node pass "
        f"{device_ms(lambda: surface.sample_surface(pos, act, MESH_128), 'surface_kernel')} (torch.profiler)")
    del got, want
    surface_odd_shapes(state.position.device)
    surface_wide_support(state.position.device)
    return out, (cycle_wall, operator_wall)


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().flatten().double().cpu(), b.detach().flatten().double().cpu()
    return float(torch.nn.functional.cosine_similarity(a, b, dim=0))


def held_to_float64(what: str, got: torch.Tensor, plain32: torch.Tensor, ref64: torch.Tensor,
                    floor: float = 1e-6) -> str:
    """A backward kernel's result against the float64 reference, beside the
    float32 plain version's: its error no more than 4 x the plain one's (or
    `floor` of the largest component where the plain one happens to be
    nearer than that: a few float32 roundings by default) and cosine >=
    0.9999. Returns text."""
    got, plain32 = got.detach().double().cpu(), plain32.detach().double().cpu()
    scale = float(ref64.abs().max())
    err_k, err_p = float((got - ref64).abs().max()), float((plain32 - ref64).abs().max())
    cos = cosine(got, ref64)
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite")
    check(err_k <= max(4.0 * err_p, floor * scale),
          f"{what}: error against float64 {err_k} > 4 x the float32 plain version's {err_p} and > "
          f"{floor} of the largest component {scale}")
    check(cos >= 0.9999, f"{what}: cosine against float64 {cos} < 0.9999")
    return (f"{what}: max|ref| {scale:.3e}, error against float64 kernel {err_k:.3e} / float32 plain "
            f"{err_p:.3e} (kernel <= 4 x plain or {floor:.0e} max|ref|), cosine {cos:.8f} (>= 0.9999)")


def kept_sums(pos: torch.Tensor, act: torch.Tensor, mcfg: MesherConfig):
    """What a forward that wants a gradient keeps for kernel F': the bins and
    the node sums of kernel F's keep form (``surface_keep``)."""
    binned = surface._binned(pos, act, mcfg)
    return binned, surface._sample_surface_keep_cuda(binned, mcfg, mcfg.particle_radius)[1]


def held_on_sound_nodes(what: str, pos: torch.Tensor, act: torch.Tensor, g: torch.Tensor,
                        mcfg: MesherConfig, float64: bool) -> str:
    """Kernel F' (on the kept node sums) at its maximum over every particle. F' is
    linear in the node cotangent `g`; a node's words carry 1 / W and the
    direction of avg - x_n, so a node of little weight, or one whose average
    sits on it, turns the roundings of any float32 version into errors far
    above the rest. With `g` set to 0 on those nodes (W <= ``THIN_W``, or
    |avg - x_n| <= ``FLAT_DIFF`` cells) the largest error of any particle is
    held to 1e-4 of the largest component: against the plain closed form on
    the card, or with `float64` against the closed form on CPU copies in
    float64. Returns text."""
    ref_pos, ref_act = (pos.cpu().double(), act.cpu()) if float64 else (pos, act)
    weight, sums = surface._node_sums(ref_pos, ref_act, mcfg)
    diff = sums / weight.clamp(min=1e-30)[..., None] - surface._node_positions(mcfg, ref_pos.dtype, ref_pos.device)
    sound = (weight > THIN_W) & (diff.norm(dim=-1) > FLAT_DIFF * mcfg.cell_size)
    del sums, diff
    g_ref = g.to(ref_pos) * sound
    want = surface._sample_surface_vjp_torch(ref_pos, ref_act, g_ref, mcfg)
    got = surface.sample_surface_bwd(*kept_sums(pos, act, mcfg), g_ref.to(g), mcfg)
    rel = float((got.to(want) - want).abs().max() / want.abs().max())
    against = "the closed form in float64 on CPU copies" if float64 else "the plain closed form"
    check(rel < 1e-4, f"surface_bwd, {what}, the cotangent of the sound nodes only: relative error {rel} >= 1e-4 "
                      f"against {against}")
    return (f"with the cotangent of the {int(sound.sum())} sound nodes only (of {int((weight > 0).sum())} with "
            f"W > 0: W > {THIN_W} and |avg - x_n| > {FLAT_DIFF} cells) the largest error of any particle "
            f"{rel:.3e} (< 1e-4) of the largest component against {against}")


def p2g_bwd_odd_shapes(device) -> None:
    """Kernel B' away from the main path's shapes, as :func:`p2g_odd_shapes`
    has kernel B: a grid no tile divides, a cell size and offset that are not
    1 and 0, 5, 12, 32 and 40 slots a cell, slots that are not prefix-dense with
    slot 0's particles on cell corners (the hats' kinks), a third of the grid
    empty, APIC and PIC; against the plain autograd (relative error < 1e-5
    on the occupied slots, empty slots 0), two launches bit-equal. The plain
    version runs on CPU copies, as in :func:`g2p_odd_shapes`: on the card
    PyTorch divides by the cell size through its reciprocal, which moves a
    particle on a corner off the hat's kink, where the slope jumps."""
    shape = (20, 18, 28)
    gen = torch.Generator(device=device).manual_seed(17)
    cell = torch.stack(torch.meshgrid(
        *(torch.arange(n, device=device, dtype=torch.float32) for n in shape), indexing="ij"))
    errs = {}
    for scheme in (TransferScheme.APIC, TransferScheme.PIC):
        for k in (5, 12, 32, 40):
            cfg = SimConfig(grid_size=shape, cell_size=0.7, grid_offset=(0.3, -0.2, 0.1),
                            scheme=scheme, max_neighbors_per_cell=k, particle_capacity=8)
            mask = (torch.rand((k, *shape), generator=gen, device=device) < 0.4).float()
            mask[..., : shape[2] // 3] = 0.0
            mask[:, 7, 5, 15] = 1.0
            off = torch.tensor(cfg.grid_offset, device=device).reshape(3, 1, 1, 1, 1)
            frac = torch.rand((3, k, *shape), generator=gen, device=device)
            frac[:, 0] = 0.0
            pos = (cell[:, None] + frac) * 0.7 + off
            rest = torch.randn((12, k, *shape), generator=gen, device=device)
            rest[3:] *= 0.2
            data = (torch.cat([pos, mask[None], rest]) * mask[None]).contiguous()
            faces = [torch.randn(sh, generator=gen, device=device) for sh in kernels.face_shapes(cfg) * 2]
            got = kernels.p2g_faces_bwd(data, faces[:3], faces[3:], cfg)
            check(torch.equal(got, kernels.p2g_faces_bwd(data, faces[:3], faces[3:], cfg)),
                  f"p2g_bwd with {k} slots a cell, {scheme.name}: two launches differ")
            leaf = data.cpu().requires_grad_()
            num, den = transfers._p2g_slots_torch(leaf, cfg)
            (want,) = torch.autograd.grad((*num, *den), leaf, [f.cpu() for f in faces])
            want = want.to(device)
            occ = data[3] != 0
            rel = max_err(got * occ, want * occ) / float(torch.max(torch.abs(want * occ)))
            errs[f"{scheme.name} {k}"] = rel
            check(rel < 1e-5, f"p2g_bwd with {k} slots a cell, {scheme.name}: relative error {rel} >= 1e-5")
            check(bool((got[:, ~occ] == 0).all()),
                  f"p2g_bwd with {k} slots a cell, {scheme.name}: an empty slot got a cotangent")
    log(f"kernel p2g_bwd (B'), odd shapes at {shape}, cell 0.7: relative error "
        + ", ".join(f"{e:.3e} ({what} slots a cell)" for what, e in errs.items())
        + " (< 1e-5), empty slots 0, two launches bit-equal")


def correction_bwd_phases(cfg, state, gen) -> dict:
    """Kernel E' (``correction_bwd``): at the 128^3 main path's slot grid
    against its plain closed form on the card (the plain autograd's tape
    does not fit there), timed with its bound; at the 32^3 scene's slot grid
    against the autograd of the plain springs on CPU copies in float64 and
    float32; at 16 and 32 slots a cell on 20 x 18 x 28 (no tile divides it)
    with coincident pairs placed by hand, and on an empty grid."""
    device = state.position.device
    sb = slotsort.sort_and_build(state, cfg)
    kc = min(cfg.correction_capacity, sb.slot_grid.capacity)
    res_pos = sb.slot_grid.position[:, :kc].contiguous()
    res_mask = sb.slot_grid.mask[:kc].contiguous()
    del sb
    re2, seed = cfg.cell_size**2 / 2.0, 12345
    g = torch.randn(res_pos.shape, generator=gen, device=device)
    dp, dm = kernels.correction_springs_bwd(res_pos, res_mask, g, re2, seed)
    wp, wm = correction._springs_vjp_torch(res_pos, res_mask, g, re2, seed, cfg)
    occ = res_mask != 0
    err = max(max_err(dp, wp), max_err(dm * occ, wm * occ))
    rel_p = max_err(dp, wp) / float(wp.abs().max())
    rel_m = max_err(dm * occ, wm * occ) / float((wm * occ).abs().max())
    check(rel_p < 1e-4 and rel_m < 1e-4,
          f"correction_bwd at 128^3: relative error positions {rel_p} mask {rel_m} >= 1e-4")
    check(bool((dp[:, ~occ] == 0).all() and (dm[~occ] == 0).all()),
          "correction_bwd: an empty slot got a cotangent")
    cos = cosine(dp, wp)
    check(cos >= 0.9999, f"correction_bwd at 128^3: cosine {cos} < 0.9999")
    dp2, none = kernels.correction_springs_bwd(res_pos, res_mask, g, re2, seed, need_mask=False)
    check(none is None and torch.equal(dp, dp2), "correction_bwd: two launches differ")
    del dp2, wp, wm
    n_occ = int(occ.sum())
    per_cell = occ.sum(0, dtype=torch.float32)
    around = 27.0 * torch.nn.functional.avg_pool3d(per_cell[None, None], 3, 1, 1)[0, 0]
    pairs = float((per_cell * (around - 1.0)).sum())  # the ordered pairs inside the grid
    # bytes: the masks read, d x and d m written, the positions and g of the
    # occupied slots read (an empty slot's outputs are 0 whatever g is there).
    # operations: the distance test every pair needs (3 differences, 3
    # products, 2 sums); the terms of the pairs closer than re, the only ones
    # that are not exact zeros, are left out, so the bound is never above the
    # work (tools/kernel_ab.py counts those pairs: their float work is far
    # below the bytes term)
    moved = nbytes(dp, dm, res_mask) + 24 * n_occ

    def springs_bwd():
        return kernels.correction_springs_bwd(res_pos, res_mask, g, re2, seed)

    rec = dict(
        **bound(moved, 8.0 * pairs),
        max_abs_err=err,
        ms=median_ms(springs_bwd),
        plain_ms=median_ms(lambda: correction._springs_vjp_torch(res_pos, res_mask, g, re2, seed, cfg),
                           PLAIN_REPS_SLOW),
    )
    log(f"kernel correction_bwd (E'): cotangents of {n_occ} resident slots at {tuple(res_pos.shape)}, "
        f"{pairs:.4e} ordered pairs in the 27 cells, relative error against the plain closed form positions {rel_p:.3e} mask "
        f"{rel_m:.3e} (< 1e-4), cosine {cos:.8f}, empty slots 0, two launches bit-equal, plain timed "
        f"over {PLAIN_REPS_SLOW} reps, {rec}; device time "
        + device_or_event_ms(springs_bwd, "correction_bwd_kernel", lambda: kernels.launch(
            "correction_bwd", "lf_correction_bwd", res_pos, res_mask, g, dp, dm, kc, *res_mask.shape[1:],
            float(re2), seed, 0, 0, 0)) + " (torch.profiler)")
    del res_pos, res_mask, g, dp, dm, occ
    torch.cuda.empty_cache()

    # the 32^3 scene's slot grid after one substep: the autograd of the plain
    # springs on CPU copies is the reference, float64 the arbiter
    cfg32, st32 = parity_scene(device)
    st32, _ = sim.substep(st32, cfg32, DT)
    sg = slotsort.sort_and_build(st32, cfg32).slot_grid
    kc = min(cfg32.correction_capacity, sg.capacity)
    res_pos, res_mask = sg.position[:, :kc].contiguous(), sg.mask[:kc].contiguous()
    g = torch.randn(res_pos.shape, generator=gen, device=device)
    dp, dm = kernels.correction_springs_bwd(res_pos, res_mask, g, re2, seed)
    refs = {}
    for dtype in (torch.float64, torch.float32):
        p = res_pos.cpu().to(dtype).requires_grad_()
        m = res_mask.cpu().to(dtype).requires_grad_()
        out = correction._springs_torch(p, m, re2, seed, cfg32)
        refs[dtype] = torch.autograd.grad(out, (p, m), g.cpu().to(dtype))
        del out
    occ = (res_mask != 0).cpu()
    log("kernel correction_bwd (E') at the 32^3 scene's slot grid, against the plain autograd on CPU copies: "
        + held_to_float64("positions", dp, refs[torch.float32][0], refs[torch.float64][0]) + "; "
        + held_to_float64("mask (occupied slots)", dm.cpu() * occ, refs[torch.float32][1] * occ,
                          refs[torch.float64][1] * occ))
    del refs

    # more slots a cell (the words kernel above 18, two words of the
    # occupancy mask at 40), coincident pairs, nothing
    shape = (20, 18, 28)
    cfg_s = SimConfig(grid_size=shape, particle_capacity=8)
    cell = torch.stack(torch.meshgrid(
        *(torch.arange(n, device=device, dtype=torch.float32) for n in shape), indexing="ij"))
    texts = []
    for kc in (16, 32, 40):
        mask = (torch.rand((kc, *shape), generator=gen, device=device) < 0.4).float()
        mask[..., : shape[2] // 3] = 0.0
        pos = cell[:, None] + torch.rand((3, kc, *shape), generator=gen, device=device)
        # coincident: two slots of one cell; a slot on a face and its twin in
        # the next cell (across a tile's edge along x)
        mask[0:3, 3, 9, 20] = 1.0
        mask[0, 4, 9, 20] = 1.0
        pos[:, 1, 3, 9, 20] = pos[:, 0, 3, 9, 20]
        pos[:, 2, 3, 9, 20] = torch.tensor([4.0, 9.5, 20.5], device=device)
        pos[:, 0, 4, 9, 20] = pos[:, 2, 3, 9, 20]
        pos = pos * mask
        g = torch.randn(pos.shape, generator=gen, device=device)
        dp, dm = kernels.correction_springs_bwd(pos, mask, g, 0.5, 99, (2, 0, 5))
        dp2, dm2 = kernels.correction_springs_bwd(pos, mask, g, 0.5, 99, (2, 0, 5))
        check(torch.equal(dp, dp2) and torch.equal(dm, dm2),
              f"correction_bwd with {kc} slots a cell: two launches differ")
        ref = correction._springs_vjp_torch(pos.cpu().double(), mask.cpu().double(), g.cpu().double(),
                                            0.5, 99, cfg_s, (2, 0, 5))
        plain = correction._springs_vjp_torch(pos.cpu(), mask.cpu(), g.cpu(), 0.5, 99, cfg_s, (2, 0, 5))
        occ = (mask != 0).cpu()
        check(float(ref[1][0:3, 3, 9, 20].abs().max()) > 0, "correction_bwd: the placed pairs are not live")
        texts.append(f"{kc} slots a cell: "
                     + held_to_float64("positions", dp, plain[0], ref[0]) + "; "
                     + held_to_float64("mask", dm.cpu() * occ, plain[1] * occ, ref[1] * occ))
    zero = torch.zeros((3, 12, *shape), device=device)
    dp, dm = kernels.correction_springs_bwd(zero, zero[0], torch.randn(zero.shape, generator=gen, device=device),
                                            0.5, 99)
    check(not bool(dp.any()) and not bool(dm.any()), "correction_bwd on an empty grid is not zero")
    log(f"kernel correction_bwd (E'), more slots a cell at {shape} with coincident pairs, against the closed "
        f"form on CPU copies in float64: " + " | ".join(texts) + "; two launches bit-equal; an empty grid "
        f"gives zeros")
    return {"correction_bwd": rec}


def surface_bwd_phases(state, gen) -> dict:
    """Kernel F's keep form (``surface_keep``, the forward of a mesh that
    wants a gradient) and kernel F' (``surface_bwd``, one launch on the kept
    node sums) at the 261^3-node grid: the keep form's values equal to the
    plain form's and its sums against the plain node sums on the card; F'
    against the plain gather of the same node words and against the plain
    closed form, each timed with its bound; F' against the autograd of the
    scatter oracle on CPU copies in float64 and float32 at the 66^3 grid of
    the 32^3 scene; with a support of 1, 2 and 4 cells on a grid no tile
    divides with a crammed bin, two launches bit-equal."""
    device = state.position.device
    pos, act = state.position.contiguous(), state.active
    n_act = int(act.sum())
    nodes = tuple(n + 1 for n in MESH_128.grid_size)
    radius = MESH_128.particle_radius
    g = torch.randn(nodes, generator=gen, device=device)
    binned = surface._binned(pos, act, MESH_128)
    values, sums = surface._sample_surface_keep_cuda(binned, MESH_128, radius)
    check(torch.equal(values, surface._sample_surface_cuda(binned, MESH_128, radius)),
          "surface_keep: its values differ from the plain form's")
    want_values, want_sums = surface._sample_surface_keep_torch(pos, act, MESH_128)
    # W and X are float32 sums of up to ~270 terms in two orders (a node's
    # particles in bin order here, the plain scatter's order there): each is
    # held to 1e-5 of its largest value; the values to F's 2e-3
    rel_w = max_err(sums[..., 0], want_sums[..., 0]) / float(want_sums[..., 0].abs().max())
    rel_x = max_err(sums[..., 1:], want_sums[..., 1:]) / float(want_sums[..., 1:].abs().max())
    err_values = max_err(values, want_values)
    check(rel_w < 1e-5 and rel_x < 1e-5,
          f"surface_keep: node sums W {rel_w}, X {rel_x} of their largest value >= 1e-5")
    check(err_values < 2e-3, f"surface_keep: values max abs error {err_values} >= 2e-3")
    check(torch.equal(sums[..., 0] == 0, want_sums[..., 0] == 0) and not bool(sums[sums[..., 0] == 0].any()),
          "surface_keep: other nodes are empty than in the plain version, or an empty node's sums are not 0")
    del want_values
    reach = 4.0 / 3.0 * np.pi * (MESH_128.particle_extent / MESH_128.cell_size) ** 3
    weight = sums[..., 0]
    n_has = int((weight > 0).sum())
    out = {"surface_keep": dict(
        # kernel F's bound with the sums written
        **bound(nbytes(values, sums) + 12 * n_act, 21.0 * reach * n_act),
        max_abs_err=max(err_values, max_err(sums, want_sums)),
        ms=median_ms(lambda: surface._sample_surface_keep_cuda(binned, MESH_128, radius)),
        plain_ms=median_ms(lambda: surface._sample_surface_keep_torch(pos, act, MESH_128), PLAIN_REPS_SLOW),
    )}
    del want_sums
    pos_s, starts, _ = binned
    geometry = surface._geometry(MESH_128)
    keep_out, keep_sums = torch.empty_like(values), torch.empty_like(sums)
    plain_node = device_or_event_ms(
        lambda: surface._sample_surface_cuda(binned, MESH_128, radius), "surface_kernel<false",
        lambda: kernels.launch("surface", "lf_surface", pos_s, starts, keep_out, *geometry, radius))
    keep_node = device_or_event_ms(
        lambda: surface._sample_surface_keep_cuda(binned, MESH_128, radius), "surface_kernel<true",
        lambda: kernels.launch("surface_keep", "lf_surface_keep", pos_s, starts, keep_out, keep_sums,
                               *geometry, radius))
    log(f"kernel surface_keep (F with the node sums kept): {nodes} nodes from {n_act} particles, values equal to "
        f"the plain form's, node sums W {rel_w:.3e} and X {rel_x:.3e} of their largest value from the plain "
        f"node sums (< 1e-5), values {err_values:.3e} (< 2e-3), the same nodes empty, plain timed over "
        f"{PLAIN_REPS_SLOW} reps, ms on the bins, {out['surface_keep']}; device time {keep_node}, the plain "
        f"form's {plain_node} (torch.profiler)")
    del keep_out, keep_sums

    # F' against the plain gather of the same node words (the kept sums),
    # those of the nodes with W > 1e-3 (the others' cotangent 0): a node's
    # words carry 1 / W, and where one far particle reaches a node W is the
    # cube of a kl of a few roundings, which the two versions' words amplify
    # differently
    well = weight > THIN_W
    n_well = int(well.sum())
    g_well = (g * well).contiguous()
    got = surface.sample_surface_bwd(binned, sums, g_well, MESH_128)
    want = surface._gather_cotangents_torch(pos, act, surface._node_words_torch(sums, g_well, MESH_128), MESH_128)
    rel = max_err(got, want) / float(want.abs().max())
    check(rel < 1e-4, f"surface_bwd: relative error {rel} >= 1e-4 against the plain gather")
    err_gather = max_err(got, want)
    del g_well, want, well
    # every node, against the plain closed form: the bulk is held to 1e-4 of
    # the largest component; the maximum is held on the sound nodes
    got = surface.sample_surface_bwd(binned, sums, g, MESH_128)
    check(not bool(got[~act].any()), "surface_bwd: an inactive particle got a cotangent")
    check(torch.equal(got, surface.sample_surface_bwd(binned, sums, g, MESH_128)), "surface_bwd: two launches differ")
    live = int((got != 0).any(dim=1).sum())
    whole_want = surface._sample_surface_vjp_torch(pos, act, g, MESH_128)
    diff = (got - whole_want).abs().amax(dim=1) / float(whole_want.abs().max())
    rel_whole = float(diff.max())
    q_whole = float(torch.quantile(diff[torch.randint(0, diff.shape[0], (1 << 20,), generator=gen,
                                                     device=device)], 0.999))
    cos_whole = cosine(got, whole_want)
    check(q_whole < 1e-4 and cos_whole >= 0.9999,
          f"surface_bwd against the closed form: 99.9th percentile of the relative error {q_whole} >= 1e-4 or "
          f"cosine {cos_whole} < 0.9999")
    del whole_want, diff
    sound_whole = held_on_sound_nodes("261^3 nodes", pos, act, g, MESH_128, False)
    # ~29 operations a particle and node within its extent, ~20 to form the
    # words of a node with W > 0
    out["surface_bwd"] = dict(
        **bound(nbytes(sums, g) + 24 * n_act, 29.0 * reach * n_act + 20.0 * n_has),
        max_abs_err=err_gather,
        ms=median_ms(lambda: surface.surface_bwd_gather(binned, sums, g, MESH_128)),
        plain_ms=median_ms(lambda: surface._gather_cotangents_torch(
            pos, act, surface._node_words_torch(sums, g, MESH_128), MESH_128), PLAIN_REPS_SLOW),
    )
    whole = median_ms(lambda: surface.sample_surface_bwd(binned, sums, g, MESH_128))
    d_alone = torch.zeros_like(pos_s)
    bwd_device = device_or_event_ms(
        lambda: surface.surface_bwd_gather(binned, sums, g, MESH_128), "surface_bwd_kernel",
        lambda: kernels.launch("surface_bwd", "lf_surface_bwd", pos_s, starts, sums, g, d_alone, *geometry))
    log(f"kernel surface_bwd (F', one launch on the kept node sums): relative error {rel:.3e} (< 1e-4) against "
        f"the plain gather of the same node words (the {n_well} nodes with W > 1e-3), against the plain closed "
        f"form on every node: 99.9th percentile {q_whole:.3e} (< 1e-4), maximum {rel_whole:.3e}, cosine "
        f"{cos_whole:.8f} (>= 0.9999), {sound_whole}; {live} particles with a cotangent, inactive 0, two "
        f"launches bit-equal, ms includes the zero fill of the result, {out['surface_bwd']}; with the write "
        f"through the sort's order {whole:.3f} ms; device time {bwd_device} (torch.profiler)")
    del binned, sums, values, got, g, d_alone
    torch.cuda.empty_cache()

    # the 32^3 scene on the 66^3 grid: the scatter oracle's autograd on CPU
    # copies is the reference, float64 the arbiter
    cfg32, st32 = parity_scene(device)
    st32, _ = sim.substep(st32, cfg32, DT)
    pos, act = st32.position.contiguous(), st32.active
    g = torch.randn(tuple(n + 1 for n in MESH_66.grid_size), generator=gen, device=device)
    got = surface.sample_surface_bwd(*kept_sums(pos, act, MESH_66), g, MESH_66)
    refs = {}
    for dtype in (torch.float64, torch.float32):
        leaf = pos.cpu().to(dtype).requires_grad_()
        (refs[dtype],) = torch.autograd.grad(
            surface._sample_surface_torch(leaf, act.cpu(), MESH_66), leaf, g.cpu().to(dtype))
    log("kernel surface_bwd (F', both launches) at the 32^3 scene's 66^3 mesher grid, against the scatter "
        "oracle's autograd on CPU copies: "
        + held_to_float64("positions", got, refs[torch.float32], refs[torch.float64], F_FLOOR) + ", "
        + held_on_sound_nodes("66^3 nodes", pos, act, g, MESH_66, True))

    # supports of 1, 2 and 4 cells, a crammed bin, particles around the grid
    grid, h, origin = (37, 30, 45), 0.5, (-1.0, 0.5, 0.25)
    lo = torch.tensor(origin, device=device)
    size = torch.tensor(grid, device=device) * h
    half = torch.tensor([0.5, 1.0, 1.0], device=device)
    fluid = lo + torch.rand((60_000, 3), generator=gen, device=device) * size * half
    around = lo - 3.0 + torch.rand((6_000, 3), generator=gen, device=device) * (size * half + 6.0)
    crammed = lo + (torch.tensor([5.0, 17.0, 30.0], device=device)
                    + torch.rand((5_000, 3), generator=gen, device=device)) * h
    pos = torch.cat([fluid, around, crammed]).contiguous()
    act = torch.arange(pos.shape[0], device=device) % 7 != 0
    texts = []
    for extent in (0.5, 1.0, 2.0):
        mcfg = MesherConfig(grid_size=grid, cell_size=h, grid_offset=origin, particle_extent=extent,
                            particle_radius=extent / 4.0)
        g = torch.randn(tuple(n + 1 for n in grid), generator=gen, device=device)
        binned, sums = kept_sums(pos, act, mcfg)
        got = surface.sample_surface_bwd(binned, sums, g, mcfg)
        check(torch.equal(got, surface.sample_surface_bwd(binned, sums, g, mcfg)),
              f"surface_bwd with extent {extent}: two launches differ")
        check(not bool(got[~act].any()), f"surface_bwd with extent {extent}: an inactive particle moved")
        ref = surface._sample_surface_vjp_torch(pos.cpu().double(), act.cpu(), g.cpu().double(), mcfg)
        plain = surface._sample_surface_vjp_torch(pos.cpu(), act.cpu(), g.cpu(), mcfg)
        texts.append(held_to_float64(f"support {round(extent / h)} cells", got, plain, ref, F_FLOOR) + ", "
                     + held_on_sound_nodes(f"support {round(extent / h)} cells", pos, act, g, mcfg, True))
    log(f"kernel surface_bwd (F'), odd shapes at {tuple(n + 1 for n in grid)} nodes from {pos.shape[0]} "
        f"particles, against the closed form on CPU copies in float64: " + " | ".join(texts)
        + "; two launches bit-equal")
    return out


def backward_kernel_phases(cfg, state) -> dict:
    """Kernels B' and D' against the autograd of their plain versions, E'
    and F' against their plain closed forms and the plain autograd, and
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
    n_occ = int(occ.sum())
    out["p2g_bwd"] = dict(
        **bound(data[3].numel() * 4 + 15 * 4 * n_occ + nbytes(*faces, got), 54 * 14.0 * n_occ),
        max_abs_err=err,
        ms=median_ms(lambda: kernels.p2g_faces_bwd(data, faces[:3], faces[3:], cfg64)),
        plain_ms=median_ms(plain_bwd, PLAIN_REPS_SLOW),
    )
    del got, want, occ, data, faces, st64
    torch.cuda.empty_cache()
    sb = slotsort.sort_and_build(state, cfg)
    data = sb.slot_grid.data.contiguous()
    faces = [torch.randn(sh, generator=gen, device=device) for sh in kernels.face_shapes(cfg) * 2]

    def b_prime_128():
        return kernels.p2g_faces_bwd(data, faces[:3], faces[3:], cfg)

    ms_128 = median_ms(b_prime_128)
    n_occ = int((data[3] != 0).sum())
    bound_128 = bound(data[3].numel() * 4 + 15 * 4 * n_occ + nbytes(*faces, data), 54 * 14.0 * n_occ)
    out["p2g_bwd"].update(ms_128=ms_128, bound_ms_128=bound_128["bound_ms"])
    log(f"kernel p2g_bwd (B'): at 64^3 (the plain autograd does not fit at 128^3), relative error "
        f"{rel:.3e} (< 1e-5) on the occupied slots, empty slots 0, plain = recompute + autograd "
        f"over {PLAIN_REPS_SLOW} reps, {out['p2g_bwd']}; B' on the 128^3 payload {ms_128:.3f} ms "
        f"against a bound of {bound_128['bound_ms']:.3f} ms ({bound_128['bound_by']}); device time there "
        f"(torch.profiler): its zero fill {device_ms(b_prime_128, 'fill_kernel')}, its pass over the occupied "
        f"slots {device_ms(b_prime_128, 'p2g_bwd_kernel')}")
    del sb, data, faces
    torch.cuda.empty_cache()
    p2g_bwd_odd_shapes(device)
    out.update(correction_bwd_phases(cfg, state, gen))
    out.update(surface_bwd_phases(state, gen))

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
    n_act = int(state.active.sum())
    out["g2p_bwd"] = dict(
        **bound(2 * nbytes(grid.u, grid.v, grid.w) + n_act * (12 + 12 + 36 + 12), 54 * 16.0 * n_act),
        max_abs_err=max(max_err(a, b) for a, b in zip(got, want)),
        ms=median_ms(lambda: transfers.g2p_bwd(grid.u, grid.v, grid.w, pos, gv, ga, cfg)),
        plain_ms=median_ms(plain_g2p_bwd, PLAIN_REPS_SLOW),
    )
    log(f"kernel g2p_bwd (D'): {n} particles, relative errors (u, v, w, position) "
        f"{[f'{r:.2e}' for r in rels]} (faces < 1e-4, position < 1e-5), plain = recompute + "
        f"autograd, {out['g2p_bwd']} (the event median includes the wrapper's zero fill); device time "
        f"{device_ms(lambda: transfers.g2p_bwd(grid.u, grid.v, grid.w, pos, gv, ga, cfg), 'g2p_bwd_kernel')} "
        f"(torch.profiler)")
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
        **bound(nbytes(x, b, x, *multigrid._level_args(l16)), 20.0 * x.numel()),
        max_abs_err=worst,
        ms=median_ms(lambda: multigrid.stencil(l16, x, b, multigrid.MODE_JACOBI, 0.8)),
        plain_ms=median_ms(lambda: multigrid._stencil_torch(l16, x, b, multigrid.MODE_JACOBI, damp)),
    )
    log(f"kernel stencil16: {len(levels)} levels x 3 modes in bfloat16, max abs error {worst:.3e} "
        f"(within 2^-8 relative), time at {tuple(l16.fluid.shape)} Jacobi mode, {out['stencil16']}; device "
        f"time {device_ms(lambda: multigrid.stencil(l16, x, b, multigrid.MODE_JACOBI, 0.8), 'stencil16_kernel')} "
        f"(torch.profiler)")
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


def thin_grid(device, precond_dtype: str = "float32") -> None:
    """A 128 x 64 x 8 dam-break with the multigrid preconditioner in
    `precond_dtype`: an axis of 8 cells ends the coarsening at once, so the
    hierarchy is one level of 65,536 cells, more than the one-block coarse
    kernel takes; its sweeps run as "stencil" launches ("stencil16" in
    bfloat16). The V-cycle against the plain cycle (bfloat16: equal), then
    three substeps on the card and on the CPU (the block falls freely
    through the first, which needs no CG iteration): healthy output, and
    the same CG iterations (within 1)."""
    cpu = torch.device("cpu")
    its, levels = {}, None
    bf16 = precond_dtype == "bfloat16"
    for dev in (device, cpu):
        cfg = SimConfig(grid_size=(128, 64, 8), cell_size=1.0, gravity=(0.0, -981.0, 0.0),
                        particle_capacity=1 << 17, scheme=TransferScheme.APIC, has_obstacles=False,
                        solver=SolverConfig(preconditioner_dtype=precond_dtype))
        state = sim.seed_box(sim.new_state(cfg, dev), cfg, (1.0, 1.0, 1.0), (63.0, 40.0, 6.0))
        n0 = int(particle_count(state))
        its[dev.type] = []
        for i in range(3):
            state, diag = sim.substep(state, cfg, DT / 4)
            healthy(state, diag, cfg, n0, f"thin grid, {dev.type} substep {i}")
            its[dev.type].append(int(diag.pressure_iterations))
        if dev == device:
            levels = multigrid.build_levels(state.grid.cell_type)
    cells = [lv.fluid.numel() for lv in levels]
    check(len(levels) == 1 and multigrid.bottom_route(cells, 0) == "sweeps",
          f"thin grid: levels of {cells} cells do not take the sweeps")
    gen = torch.Generator(device=device).manual_seed(3)
    b = 20.0 * torch.randn(levels[0].fluid.shape, generator=gen, device=device) * levels[0].fluid
    if bf16:
        levels, b = bf16_levels(levels), b.to(torch.bfloat16)
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    got = multigrid.v_cycle(levels, b)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
    want = multigrid._coarse_torch(levels, b, 0)
    err, tol = max_err(got, want), 0.0 if bf16 else 1e-5 * float(b.abs().max())
    check(torch.equal(got, want) if bf16 else err <= tol,
          f"thin grid: V-cycle differs from the plain cycle by {err} > {tol}")
    sweeps = "stencil16" if bf16 else "stencil"
    check(launched == {sweeps: multigrid._COARSE_ITERS}, f"thin grid: a V-cycle launched {launched}")
    log(f"thin grid {tuple(levels[0].fluid.shape)} ({precond_dtype} preconditioner), one level of "
        f"{cells[0]} cells: V-cycle against plain max abs error {err:.3e} (<= {tol:.3e}), {launched} "
        f"launches a cycle, "
        f"{wall_ms(lambda: multigrid.v_cycle(levels, b)):.4f} ms on the host clock; CG iterations of three "
        f"substeps gpu {its[device.type]} cpu {its['cpu']}, {n0} particles, healthy")
    check(max(its["cpu"]) > 0 and all(abs(g - c) <= 1 for g, c in zip(its[device.type], its["cpu"])),
          f"thin grid: CG iterations gpu {its[device.type]} cpu {its['cpu']} differ by more than 1")


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
    """The gradient path: 2 descent steps on the 128^3 correction-off
    dam-break."""
    cfg, state = dam_break(128, device, 1 << 21, correct=False)
    descent(cfg, state, 2, GRAD_LR, "128^3 descent", int(particle_count(state)))


def grad_run_correction(device) -> None:
    """The main path's configuration under a gradient: one descent step on
    the 128^3 dam-break with position correction on (kernels E and E')."""
    cfg, state = dam_break(128, device, 1 << 21, correct=True)
    descent(cfg, state, 1, GRAD_LR, "128^3 correction-on descent", int(particle_count(state)))


def mesh_grad_run(device) -> None:
    """The gradient of a loss on the mesh of the 260^3-cell mesher grid with
    respect to the 2.0M positions of the 128^3 dam-break after one substep
    (kernel F in the form that keeps the node sums, then kernel F'): finite,
    and non-zero on the particles near the surface only; the forward
    launches ``surface_keep`` once and no ``surface``, the backward
    ``surface_bwd`` once and no node pass. Then the same mesh under
    ``no_grad``: ``surface`` alone, nothing kept (its peak memory beside)."""
    cfg, state = dam_break(128, device, 1 << 21)
    state, _ = sim.substep(state, cfg, DT)
    act = state.active
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pos = state.position.detach().clone().requires_grad_()
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    mesh = generate_mesh(pos, act, MESH_128)
    loss = mesh_loss(mesh)
    torch.cuda.synchronize()
    fwd = time.perf_counter() - t0
    forward = {k: kernels.LAUNCHES[k] - before[k] for k in ("surface", *MESH_GRAD_KERNELS)}
    t0 = time.perf_counter()
    (g,) = torch.autograd.grad(loss, pos)
    torch.cuda.synchronize()
    bwd = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    both = {k: kernels.LAUNCHES[k] - before[k] for k in ("surface", *MESH_GRAD_KERNELS)}
    count = int(mesh.count)
    live = int((g != 0).any(dim=1).sum())
    gnorm = float(torch.linalg.vector_norm(g))
    log(f"mesh gradient {tuple(n + 1 for n in MESH_128.grid_size)} nodes: {count} triangles, forward "
        f"{fwd * 1e3:.1f} ms, backward {bwd * 1e3:.1f} ms, loss {float(loss.detach()):.6e}, |grad| "
        f"{gnorm:.6e}, {live} of {int(act.sum())} particles with a gradient, peak memory "
        f"{peak / 2**30:.2f} GiB ({peak} B)")
    log(f"launches of the mesh gradient: forward {forward}, forward and backward {both} (no second node pass)")
    check(0 < count < MESH_128.max_triangles, f"mesh gradient: {count} triangles")
    check(bool(torch.isfinite(g).all()) and gnorm > 0, "mesh gradient: zero or non-finite")
    check(0 < live < int(act.sum()), f"mesh gradient: {live} particles with a gradient")
    check(not bool(g[~act].any()), "mesh gradient: an inactive particle has a gradient")
    check(forward == {"surface": 0, "surface_keep": 1, "surface_bwd": 0}
          and both == {"surface": 0, "surface_keep": 1, "surface_bwd": 1},
          f"mesh gradient: launches {forward} in the forward, {both} in all")
    del mesh, loss, g
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    with torch.no_grad():
        mesh = generate_mesh(pos, act, MESH_128)
    torch.cuda.synchronize()
    plain = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launched = {k: kernels.LAUNCHES[k] - before[k] for k in ("surface", *MESH_GRAD_KERNELS)}
    log(f"the same mesh under no_grad: {int(mesh.count)} triangles in {plain * 1e3:.1f} ms, launches {launched}, "
        f"peak memory {peak / 2**30:.2f} GiB ({peak} B)")
    check(launched == {"surface": 1, "surface_keep": 0, "surface_bwd": 0},
          f"the mesh under no_grad launched {launched}")


def flip_run(device) -> None:
    """3 substeps of the 128^3 dam-break with FLIP and the mg16 V-cycle (the
    first from rest needs no CG iteration), then the stage split of 2
    more and one substep under the profiler (the device's busy share)."""
    cfg, state = dam_break(128, device, 1 << 21, correct=False)
    cfg = flip_mg16(cfg)
    n0 = int(particle_count(state))
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, diag = sim.substep(state, cfg, DT)
        torch.cuda.synchronize()
        healthy(state, diag, cfg, n0, f"FLIP mg16 substep {i}")
        log(f"128^3 FLIP + mg16 substep {i}: {(time.perf_counter() - t0) * 1e3:.1f} ms, CG "
            f"{int(diag.pressure_iterations)} it res {float(diag.pressure_residual):.2e}, vmax "
            f"{float(diag.max_velocity):.2f}, n {int(diag.particle_count)}")
    state = stage_split(state, cfg, n0, None, substeps=2, what="128^3 FLIP + mg16")
    busy_share(state, cfg, n0, "128^3 FLIP + mg16")


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


def stage_split(state, cfg, n0: int, cg_parts, substeps: int = 3, what: str = "128^3"):
    """`substeps` substeps under ``profiling.tracing()``: host ms per stage
    (the mean of the program's own spans of a substep: the host's enqueue
    and its reads, no synchronize between stages), CG iterations and the
    pressure span's host ms per CG iteration, held beside `cg_parts` (if
    given), the ms of one V-cycle and one operator call."""
    total, iters = 0.0, 0
    profiling.clear()
    with profiling.tracing():
        for i in range(substeps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, diag = sim.substep(state, cfg, DT)
            torch.cuda.synchronize()
            total += (time.perf_counter() - t0) * 1e3
            iters += int(diag.pressure_iterations)
            healthy(state, diag, cfg, n0, f"staged substep {i}")
    spent, reads = {}, 0
    for f in profiling.frames():
        for s in f.spans:
            if s.parent is not None and s.parent.name == "substep":
                spent[s.name] = spent.get(s.name, 0.0) + s.ns / 1e6
        reads += f.total("reads")
    profiling.clear()
    rest = total - sum(spent.values())
    solve = spent.get("pressure", 0.0)
    log(f"{what} stage split (the program's spans), mean of {substeps} substeps: total {total / substeps:.2f} ms, "
        f"CG {iters / substeps:.2f} iterations a substep, {solve / max(iters, 1):.3f} host ms per CG iteration, "
        f"{reads / substeps:.1f} host reads a substep")
    for name, ms in (*sorted(spent.items(), key=lambda kv: -kv[1]),
                     ("gravity, the substep's own work and the final synchronize", rest)):
        log(f"  stage {name}: {ms / substeps:.2f} ms ({100.0 * ms / total:.1f} %)")
    if cg_parts is None:
        return state
    # what a CG iteration is made of: its V-cycle and its operator as timed
    # alone in phase 3 (outside this path, whose launch counts are its own);
    # the rest is the loop's vector operations, its host read of the
    # residual and the solve's set-up, apply_pressure included
    cycle, operator = cg_parts
    per_it = solve / max(iters, 1)
    log(f"  a CG iteration of {per_it:.3f} ms: V-cycle {cycle:.3f} ms ({100.0 * cycle / per_it:.0f} %), "
        f"operator {operator:.3f} ms, the loop's vector operations and host read "
        f"{per_it - cycle - operator:.3f} ms")
    return state


def solve_inputs(state, cfg):
    """The arguments ``substep`` gives ``pressure.solve`` from `state` (one
    substep run to capture them; the state's draws are restored)."""
    captured, solve = [], pressure.solve

    def grab(*args, **kwargs):
        captured.append((args, kwargs))
        return solve(*args, **kwargs)

    draws = state.generator.get_state()
    pressure.solve = grab
    try:
        sim.substep(state, cfg, DT)
    finally:
        pressure.solve = solve
        state.generator.set_state(draws)
    return captured[0]


def profiled_solve(args, kwargs, cfg):
    """One ``pressure.solve`` under torch.profiler: (CG iterations, wall ms,
    device ms by part: the V-cycle's kernels, the operator, the rest; the
    device's idle ms after each host read of the residual, from the end of
    its copy to the host to the start of the next device item)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = pressure.solve(*args[:1], cfg, *args[2:], **kwargs)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    items = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                   key=lambda e: e.time_range.start)
    parts = {"V-cycle kernels": 0.0, "operator": 0.0, "vector and reduction ops": 0.0}
    read_gap = 0.0
    for e, after in zip(items, items[1:] + [None]):
        name = e.name
        part = ("V-cycle kernels" if "mg_" in name and "_kernel" in name
                else "operator" if "stencil_kernel" in name else "vector and reduction ops")
        parts[part] += e.device_time_total / 1e3
        if "DtoH" in name and after is not None:
            read_gap += max(after.time_range.start - e.time_range.end, 0.0) / 1e3
    return int(res.iterations), wall, parts, read_gap


def cg_iteration_split(state, cfg, what: str = "128^3") -> None:
    """What one CG iteration of the main path's solve is made of, on the
    solve that a substep from `state` makes: the solve run to convergence
    and with 2 iterations, each on the host clock (mean of 3) and once under
    torch.profiler; their difference over the iterations between is one
    iteration's wall time, its device busy time split into the V-cycle's
    kernels, the operator and PyTorch's vector and reduction ops, and the
    device's idle time after the host read of the residual."""
    args, kwargs = solve_inputs(state, cfg)
    short = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, max_iterations=2))
    runs = {}
    for name, c in (("full", cfg), ("short", short)):
        plain_wall = wall_ms(lambda: pressure.solve(*args[:1], c, *args[2:], **kwargs), 3)
        runs[name] = (plain_wall, *profiled_solve(args, kwargs, c))
    (w_full, it_full, pw_full, parts_full, gap_full), (w_short, it_short, pw_short, parts_short, gap_short) = (
        runs["full"], runs["short"])
    check(it_short == 2 and it_full > 2, f"{what} CG split: iterations {it_full} and {it_short}")
    k = it_full - it_short
    parts = {name: (parts_full[name] - parts_short[name]) / k for name in parts_full}
    busy = sum(parts.values())
    wall, pwall, gap = (w_full - w_short) / k, (pw_full - pw_short) / k, (gap_full - gap_short) / k
    log(f"{what} CG iteration split ({it_full} iterations against {it_short}): wall {wall:.4f} ms "
        f"(under the profiler {pwall:.4f}); device busy {busy:.4f} ms = "
        + ", ".join(f"{name} {ms:.4f}" for name, ms in parts.items())
        + f"; device idle {pwall - busy:.4f} ms under the profiler, of it {gap:.4f} ms from the end of "
        f"the residual's copy to the host to the next device item (the host read)")


def busy_share(state, cfg, n0: int, what: str = "128^3"):
    """One substep under torch.profiler: the device's busy share of the
    wall time and the largest device items."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, diag = sim.substep(state, cfg, DT)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    healthy(state, diag, cfg, n0, "profiled substep")
    on_device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in on_device) / 1e3
    check(busy > 0, "torch.profiler saw no device time")
    log(f"{what} profiled substep: wall {wall:.1f} ms with {int(diag.pressure_iterations)} CG iterations, "
        f"device busy {busy:.2f} ms = {100.0 * busy / wall:.1f} % of the wall time; largest device items: "
        + "; ".join(f"{e.key[:48]} x{e.count} {e.device_time_total / 1e3:.2f} ms"
                    for e in sorted(on_device, key=lambda e: -e.device_time_total)[:8]))
    return state


def dam_break_run(device, correct: bool, substeps: int, cg_parts=None):
    """The 128^3 dam-break: one warm-up substep, `substeps` timed ones and,
    given `cg_parts` (see :func:`stage_split`), the stage split, the
    profiled substep and one CFL step(1/60); then, with correction, the
    mesh, whose triangles it returns ((T, 3, 3) vertices, (T,) valid)."""
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

    if cg_parts is not None:
        state = stage_split(state, cfg, n0, cg_parts)
        cg_iteration_split(state, cfg)
        state = busy_share(state, cfg, n0)
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
        return tris.contiguous(), mesh.valid[:count].contiguous()
    return None


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


# the renderer: BASELINE configs 1 and 2 (bench.py's bench_rays) and 3
# (bench_e2e_64); the water of config 3's fluid box
RENDER_SCENES = {"cornell": scenes.cornell_box_one_light, "glass": scenes.glass_ball_box}
WATER = (0.4, 0.55, 0.8)
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden")


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a - b) ** 2))
    peak = float(max(a.max(), b.max(), 1e-6))
    return 10.0 * np.log10(peak * peak / max(mse, 1e-20))


def render_configs_1_2(device) -> dict:
    """Configs 1 and 2 as bench.py sets them: Cornell and glass at 256^2 x
    32 spp, max_bounces 5, the persistent brute tracer with its cast count;
    the wall time of the second call, rays cast, Mrays/s (cast-accounted)
    and the host reads of the loop. Returns each image's mean."""
    cfg = RenderConfig(width=256, height=256, samples_per_pixel=32, max_bounces=5, differentiable=False)
    means = {}
    for number, (name, mk) in enumerate(RENDER_SCENES.items(), start=1):
        b, cam = mk(1.0, device=device)
        scene = b.finish(device=device)
        pathtrace.trace_persistent(scene, cam, cfg, torch.Generator().manual_seed(0), True)
        torch.cuda.synchronize()
        loops.reset_host_reads()
        t0 = time.perf_counter()
        img, cast = pathtrace.trace_persistent(scene, cam, cfg, torch.Generator().manual_seed(1), True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        reads, rays = loops.HOST_READS["count"], int(cast)
        img = img / cfg.samples_per_pixel
        check(img.device.type == "cuda", f"config {number}: the image is not on the card")
        check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0, f"config {number}: image not finite or black")
        log(f"render config {number} ({name}) 256^2 x 32 spp, max_bounces 5, persistent brute tracer: "
            f"{wall:.4f} s (second call), {rays} rays cast "
            f"({rays / (cfg.width * cfg.height * cfg.samples_per_pixel):.3f} a path), "
            f"{rays / wall / 1e6:.3f} Mrays/s (cast-accounted), {reads} host reads, image mean "
            f"{float(img.mean()):.5f}")
        means[name] = float(img.mean())
    return means


def render_goldens(device) -> None:
    """Cornell and glass at 64^2 x 128 spp, max_bounces 5, with each tracer
    (the fixed-count one of ``render``'s default and the persistent one),
    against tests/golden/*_64.npz: PSNR > 26 dB and the mean within 3 %,
    the rule of tests/test_golden_images.py."""
    texts = []
    for name, mk in RENDER_SCENES.items():
        golden = np.load(os.path.join(GOLDEN_DIR, f"{name}_64.npz"))["img"]
        b, cam = mk(1.0, device=device)
        scene = b.finish(device=device)
        for differentiable, tracer in ((True, "fixed-count"), (False, "persistent")):
            cfg = RenderConfig(width=64, height=64, samples_per_pixel=128, max_bounces=5,
                               differentiable=differentiable)
            t0 = time.perf_counter()
            img = render(scene, cam, cfg, torch.Generator().manual_seed(7), device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            img = img.cpu().numpy()
            p, rel = psnr(img, golden), abs(float(img.mean()) / float(golden.mean()) - 1.0)
            check(bool(np.isfinite(img).all()) and p > 26.0 and rel < 0.03,
                  f"golden {name}, {tracer} tracer: PSNR {p:.2f} dB, mean off by {rel:.4f}")
            texts.append(f"{name} {tracer}: PSNR {p:.2f} dB, mean off by {100 * rel:.2f} % ({wall:.3f} s)")
    log("render against the golden images at 64^2 x 128 spp (PSNR > 26 dB, mean within 3 %): " + "; ".join(texts))


def fluid_scene(n: float, vertices: torch.Tensor, valid: torch.Tensor, device):
    """The fluid box around an n^3 domain with the water mesh injected, and
    its camera."""
    b, cam = scenes.fluid_box((0.0, 0.0, 0.0), (n, n, n), device=device)
    water = b.lambertian(WATER)
    return inject_mesh(b.finish(device=device), vertices, valid, water), cam


def render_config_3(device):
    """Config 3 as bench.py sets it: the 64^3 APIC dam-break (capacity 2^18,
    seed box (1, 1, 1)-(31, 31, 31), no obstacles), a substep of 0.02, the
    mesh on 64^3 cells of 1.0 (2^17 triangles), the fluid box with the water
    mesh injected, the accelerator at 64^3, and the megakernel at 256^2 x 4
    spp, max_bounces 4. Three warm-up frames, one timed; the ms of each part
    (a synchronize after each), triangles, rays cast, host reads. Returns the
    timed frame's mesh ((T, 3, 3) vertices, (T,) valid)."""
    cfg = SimConfig(grid_size=(64, 64, 64), gravity=(0.0, -981.0, 0.0), particle_capacity=1 << 18,
                    scheme=TransferScheme.APIC, has_obstacles=False)
    state = sim.seed_box(sim.new_state(cfg, device), cfg, (1.0, 1.0, 1.0), (31.0, 31.0, 31.0))
    mcfg = MesherConfig(grid_size=(64, 64, 64), cell_size=1.0, max_triangles=1 << 17)
    b, cam = scenes.fluid_box((0.0, 0.0, 0.0), (64.0, 64.0, 64.0), device=device)
    water = b.lambertian(WATER)
    scene0 = b.finish(device=device)
    rcfg = RenderConfig(width=256, height=256, samples_per_pixel=4, max_bounces=4, differentiable=False)

    def frame(state, seed):
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        state, diag = sim.substep(state, cfg, DT)
        mark()
        mesh = generate_mesh(state.position, state.active, mcfg)
        mark()
        scene = inject_mesh(scene0, mesh.vertices, mesh.valid, water)
        scene = scene._replace(accel=accel.build(scene, res=(64, 64, 64), device=device))
        mark()
        loops.reset_host_reads()
        img, cast = pathtrace.trace_persistent(scene, cam, rcfg, torch.Generator().manual_seed(seed), True)
        img = img / rcfg.samples_per_pixel
        mark()
        ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
        return state, diag, mesh, scene, img, int(cast), loops.HOST_READS["count"], ms

    for i in range(3):
        state, *_ = frame(state, 1 + i)
    state, diag, mesh, scene, img, rays, reads, ms = frame(state, 9)
    count = int(mesh.count)
    check(float(diag.pressure_residual) < 1e-5, f"config 3: CG residual {float(diag.pressure_residual)}")
    check(0 < count < mcfg.max_triangles, f"config 3: {count} triangles")
    check(int(scene.accel.big_overflow) == 0, "config 3: the accelerator's big list overflowed")
    check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0, "config 3: image not finite or black")
    log(f"render config 3 (64^3 simulate -> mesh -> render frame, the 4th of 4): {sum(ms):.1f} ms = substep "
        f"{ms[0]:.1f} + mesh {ms[1]:.1f} + accel build {ms[2]:.1f} + render {ms[3]:.1f} (megakernel, 256^2 x 4 "
        f"spp, max_bounces 4); {count} triangles, {rays} rays cast, {rays / (ms[3] / 1e3) / 1e6:.3f} Mrays/s "
        f"in the render, {reads} host reads, CG {int(diag.pressure_iterations)} it, image mean "
        f"{float(img.mean()):.5f}")
    return mesh.vertices[:count].contiguous(), mesh.valid[:count].contiguous()


def accel_at_fluid_scale(device, meshes) -> None:
    """The accelerator on fluid meshes: for each (what, domain, res,
    vertices, valid) the fluid box with the mesh injected, ``accel.build``
    at `res` with no big-list overflow, ``traverse`` of 8,192 rays from
    points in the domain against ``_brute_force_tris`` on the card (the same
    hits and materials, t within rtol 1e-5), and the device ms of the build
    and of the traversal of the camera's 65,536 primary rays (256^2)."""
    for what, n, res, vertices, valid in meshes:
        scene, cam = fluid_scene(n, vertices, valid, device)
        acc = accel.build(scene, res=res, device=device)
        check(int(acc.big_overflow) == 0, f"accel {what}: {int(acc.big_overflow)} big triangles dropped")
        pack = accel.pack_tris(scene)
        gen = torch.Generator(device=device).manual_seed(3)
        o = torch.rand((8192, 3), generator=gen, device=device) * n
        d = torch.randn((8192, 3), generator=gen, device=device)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        t, tid, _, _ = accel.traverse(acc, pack, o, d, 3.0e38)
        bt, bid, _, _ = intersect._brute_force_tris(scene, o, d, 3.0e38)
        hit = bid >= 0
        check(torch.equal(tid >= 0, hit), f"accel {what}: {int(((tid >= 0) != hit).sum())} hits differ")
        check(torch.equal(scene.tri_mat[tid.clamp(min=0)][hit], scene.tri_mat[bid.clamp(min=0)][hit]),
              f"accel {what}: materials differ")
        check(close(t[hit], bt[hit], 1e-5, 0.0), f"accel {what}: t differs by {max_err(t[hit], bt[hit])}")
        water_hits = int((scene.tri_mat[bid.clamp(min=0)][hit] == scene.tri_mat.max()).sum())
        gx, gy = torch.meshgrid(torch.arange(256, device=device, dtype=torch.float32),
                                torch.arange(256, device=device, dtype=torch.float32), indexing="xy")
        po, pd = cam.get_rays((torch.stack([gx, gy], -1).reshape(-1, 2) + 0.5) / 256.0)
        build_ms = median_ms(lambda: accel.build(scene, res=res, device=device), 5)
        loops.reset_host_reads()
        accel.traverse(acc, pack, po, pd, 3.0e38)
        reads = loops.HOST_READS["count"]
        trav_ms = median_ms(lambda: accel.traverse(acc, pack, po, pd, 3.0e38), 5)
        log(f"accel {what}: {vertices.shape[0]} mesh triangles, res {res}, {acc.tri_ids.shape[0]} entries, "
            f"big overflow 0; 8192 rays: {int(hit.sum())} hits ({water_hits} on the water) equal to the brute "
            f"force on the card, t within rtol 1e-5 (max abs {max_err(t[hit], bt[hit]):.3e}); build "
            f"{build_ms:.3f} ms, traverse of 65536 primary rays {trav_ms:.3f} ms ({reads} host reads)")


def render_busy_share(device) -> None:
    """One config-1 Cornell render (persistent tracer) under torch.profiler:
    the device's busy share of the wall time and the largest device items."""
    b, cam = scenes.cornell_box_one_light(1.0, device=device)
    scene = b.finish(device=device)
    cfg = RenderConfig(width=256, height=256, samples_per_pixel=32, max_bounces=5, differentiable=False)
    render(scene, cam, cfg, torch.Generator().manual_seed(0), device=device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render(scene, cam, cfg, torch.Generator().manual_seed(1), device=device)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    on_device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in on_device) / 1e3
    check(busy > 0, "torch.profiler saw no device time in the render")
    log(f"profiled Cornell render 256^2 x 32 spp (persistent): wall {wall:.1f} ms, device busy {busy:.2f} ms = "
        f"{100.0 * busy / wall:.1f} % of the wall time; largest device items: "
        + "; ".join(f"{e.key[:48]} x{e.count} {e.device_time_total / 1e3:.2f} ms"
                    for e in sorted(on_device, key=lambda e: -e.device_time_total)[:8]))


def scene_cli_run() -> None:
    """The testbed CLI's ``--scene cornell1`` at its defaults (400^2, 16
    spp, the fixed-count tracer) on the card: a P6 PPM of the right size."""
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        rc = testbed_cli.main(["--scene", "cornell1", "--out", out])
        log(f"testbed --scene cornell1 (400^2 x 16 spp): rc {rc}, {time.perf_counter() - t0:.2f} s")
        check(rc == 0, f"testbed --scene exited with {rc}")
        data = open(os.path.join(out, "cornell1.ppm"), "rb").read()
        header = b"P6\n400 400\n255\n"
        check(data.startswith(header) and len(data) == len(header) + 400 * 400 * 3,
              f"cornell1.ppm: header {data[:16]!r}, {len(data)} bytes")
        check(np.frombuffer(data[len(header):], np.uint8).max() > 0, "cornell1.ppm is black")


def renderer_phases(device, mesh128) -> dict:
    """The renderer: configs 1 and 2, both tracers against the golden
    images, config 3's frame (driven, with the kernels of its substep and
    mesher), the accelerator on config 3's and the 128^3 main path's
    meshes, a profiled render and the CLI's --scene; then BDPT at full
    width and against the goldens, the voxelizer on both meshes, the
    testbed's rendered frames (driven), and the pixel gradient: card
    against CPU at 16^3 and config 3's at full width (both driven). Returns
    BDPT's Mrays/s."""
    pt_means = render_configs_1_2(device)
    render_goldens(device)
    mesh64, _ = drive("config 3 frame (64^3 simulate -> mesh -> render)", lambda: render_config_3(device),
                      FORWARD_KERNELS)
    accel_at_fluid_scale(device, [("config 3's 64^3 frame", 64.0, (64, 64, 64), *mesh64),
                                  ("the 128^3 main path's mesh", 128.0, (128, 128, 128), *mesh128)])
    render_busy_share(device)
    scene_cli_run()
    rates = bdpt_full_width(device, pt_means)
    bdpt_goldens(device)
    voxelize_meshes(device, mesh128, mesh64)
    del mesh64
    torch.cuda.empty_cache()
    drive("testbed --render-every path (setup 0, PT and BDPT)", lambda: fluid_frames(device), FORWARD_KERNELS)
    torch.cuda.empty_cache()
    drive("pixel gradient parity (16^3 composed gate)", lambda: pixel_grad_parity(device), ())
    torch.cuda.empty_cache()
    drive("config 3 pixel gradient (two 64^3 substeps -> mesh -> 256^2 render)",
          lambda: pixel_grad_full_width(device), (*FORWARD_KERNELS, *BACKWARD_KERNELS))
    torch.cuda.empty_cache()
    return rates


# --- the second renderer slice and the harness ----------------------------------

def bdpt_image(scene, cam, cfg: RenderConfig, seed: int):
    """``bench.py``'s BDPT loop: per sample, every pixel's jittered ray in
    one batch through ``bdpt.trace_rays(with_stats=True)`` on a
    :class:`HashDraws` of `seed`. Returns the mean image (H*W, 3) and the
    rays cast."""
    draws = HashDraws(seed)
    w, h = cfg.width, cfg.height
    gx, gy = torch.meshgrid(torch.arange(w, dtype=torch.float32, device=scene.device),
                            torch.arange(h, dtype=torch.float32, device=scene.device), indexing="xy")
    base = torch.stack([gx, gy], dim=-1).reshape(-1, 2)
    inv = torch.tensor([1.0 / w, 1.0 / h], device=scene.device)
    acc = torch.zeros((w * h, 3), device=scene.device)
    cast = torch.zeros((), dtype=torch.int64, device=scene.device)
    for sample in range(cfg.samples_per_pixel):
        o, d = cam.get_rays((base + draws.jitter(sample, w * h, scene.device)) * inv)
        rad, c = bdpt.trace_rays(scene, o, d, draws.bdpt(sample, 0), cfg, with_stats=True)
        acc, cast = acc + rad, cast + c
    return acc / cfg.samples_per_pixel, cast


def bdpt_full_width(device, pt_means) -> dict:
    """BDPT as ``bench.py`` runs it (Cornell and glass at 256^2 x 32 spp,
    6 camera and 6 light bounces, each sample's 65,536 rays one batch): the
    wall time of the second call, rays cast, Mrays/s (cast-accounted), host
    reads; the image mean within 8 % (Cornell) / 12 % (glass) of the
    persistent PT image's of configs 1 / 2 (`pt_means`), the bounds of
    tests/test_bdpt.py. Returns each scene's Mrays/s."""
    cfg = RenderConfig(width=256, height=256, samples_per_pixel=32, algorithm="bdpt")
    rates = {}
    for (name, mk), bound_rel in zip(RENDER_SCENES.items(), (0.08, 0.12)):
        b, cam = mk(1.0, device=device)
        scene = b.finish(device=device)
        bdpt_image(scene, cam, dataclasses.replace(cfg, samples_per_pixel=1), 0)
        torch.cuda.synchronize()
        loops.reset_host_reads()
        t0 = time.perf_counter()
        img, cast = bdpt_image(scene, cam, cfg, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rays, reads = int(cast), loops.HOST_READS["count"]
        mean = float(img.mean())
        rel = abs(mean / pt_means[name] - 1.0)
        check(bool(torch.isfinite(img).all()) and float(img.min()) >= 0, f"BDPT {name}: image not finite")
        check(rel < bound_rel, f"BDPT {name}: mean {mean} off the PT mean {pt_means[name]} by {rel:.4f}")
        rates[name] = rays / wall / 1e6
        log(f"BDPT {name} 256^2 x 32 spp, 6 + 6 bounces: {wall:.4f} s (second call), {rays} rays cast "
            f"({rays / (cfg.width * cfg.height * cfg.samples_per_pixel):.3f} a path), {rates[name]:.3f} Mrays/s "
            f"(cast-accounted), {reads} host reads, image mean {mean:.5f} against the PT image's "
            f"{pt_means[name]:.5f} (off by {100 * rel:.2f} %, bound {100 * bound_rel:.0f} %)")
    return rates


def bdpt_goldens(device) -> None:
    """BDPT through ``render(algorithm="bdpt")`` at 64^2 x 32 spp with the
    default 6 camera and 6 light bounces, against tests/golden/*_64.npz (PT
    at 128 spp, 5 bounces): the mean within 8 % (Cornell) / 12 % (glass).
    With 5 + 5 bounces the Cornell mean sat 8.3 % under the golden's: the
    JAX package's BDPT, which the port equals on injected draws, reads
    darker than its PT on the Cornell box (7.2 % at 256^2)."""
    texts = []
    for (name, mk), bound_rel in zip(RENDER_SCENES.items(), (0.08, 0.12)):
        golden = np.load(os.path.join(GOLDEN_DIR, f"{name}_64.npz"))["img"]
        b, cam = mk(1.0, device=device)
        cfg = RenderConfig(width=64, height=64, samples_per_pixel=32, algorithm="bdpt")
        t0 = time.perf_counter()
        img = render(b.finish(device=device), cam, cfg, torch.Generator().manual_seed(7), device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        img = img.cpu().numpy()
        rel = abs(float(img.mean()) / float(golden.mean()) - 1.0)
        check(bool(np.isfinite(img).all()) and rel < bound_rel, f"BDPT golden {name}: mean off by {rel:.4f}")
        texts.append(f"{name}: mean off by {100 * rel:.2f} % (bound {100 * bound_rel:.0f} %), PSNR "
                     f"{psnr(img, golden):.2f} dB ({wall:.3f} s)")
    log("BDPT against the golden images at 64^2 x 32 spp: " + "; ".join(texts))


def fluid_frames(device) -> None:
    """The testbed CLI renders the simulation: setup 0, 2 frames with
    ``--render-every 1 --render-size 256 --spp 4`` (the forward tracer, the
    default ``--tri-capacity`` of 2^17), then 1 frame with ``--algorithm
    bdpt`` at 256^2 x 1 spp. Each frame's split from the program's own
    spans under ``profiling.tracing()`` (host ms of step, mesh, accel =
    ``accel.build`` and render; the testbed builds the rest of its scene on
    the host, outside any span); every PPM written, of the right size and
    not black."""
    runs = (("pt", ["--frames", "2", "--spp", "4"]), ("bdpt", ["--frames", "1", "--spp", "1", "--algorithm", "bdpt"]))
    names = ("step", "mesh", "accel", "render")
    for algorithm, extra in runs:
        profiling.clear()
        with tempfile.TemporaryDirectory() as out, profiling.tracing():
            t0 = time.perf_counter()
            rc = testbed_cli.main(["--setup", "0", "--render-every", "1", "--render-size", "256", "--out", out,
                                   *extra], device=device)
            wall = time.perf_counter() - t0
            check(rc == 0, f"testbed --render-every ({algorithm}) exited with {rc}")
            frames = int(extra[1])
            for frame in range(frames):
                data = open(os.path.join(out, f"frame_{frame:05d}.ppm"), "rb").read()
                header = b"P6\n256 256\n255\n"
                check(data.startswith(header) and len(data) == len(header) + 256 * 256 * 3,
                      f"frame {frame} ({algorithm}): {len(data)} bytes")
                check(np.frombuffer(data[len(header):], np.uint8).max() > 0, f"frame {frame} ({algorithm}) is black")
        recorded = [f for f in profiling.frames() if f.named("step")]
        profiling.clear()
        split = ", ".join(f"{name} {sum(s.ns for f in recorded for s in f.named(name)) / 1e6 / len(recorded):.1f}"
                          for name in names)
        reads = sum(f.total("reads") for f in recorded) / len(recorded)
        log(f"testbed setup 0 --render-every 1, 256^2, {algorithm} ({' '.join(extra)}): rc 0, {wall:.2f} s for "
            f"{frames} frame(s); host ms a frame (the program's spans): {split}; {reads:.1f} host reads a frame")


def ramp_texels() -> np.ndarray:
    """A smooth 8x8 albedo ramp over a triangle's barycentric uv: the
    water's texture where a pixel gradient must not vanish (a constant
    lambertian albedo under a constant emitter gives a path weight that
    does not depend on where the surface is hit)."""
    u = np.linspace(0.0, 1.0, 8)
    return np.stack([0.2 + 0.8 * np.broadcast_to(u[None, :], (8, 8)),
                     0.2 + 0.8 * np.broadcast_to(u[:, None], (8, 8)), np.full((8, 8), 0.6)], -1)


def pixel_loss(cfg, state, vel, mcfg, scene0, water, cam, rcfg, seed: int, dt: float, substeps: int = 1):
    """The mean pixel (summed in float64) of the mesh after `substeps`
    substeps, rendered differentiably: the substeps' draws from a generator
    seeded 0, the render's from ``HashDraws(seed)``. A substep advects with
    the velocity it starts with, so with one substep the gradient with
    respect to the initial velocities passes through advection, the
    correction springs (E') and the mesher (F') only; from the second on
    also through G2P (D'), the pressure solve's adjoint and P2G (B')."""
    st = state._replace(velocity=vel, generator=torch.Generator().manual_seed(0))
    for _ in range(substeps):
        st, diag = sim.substep(st, cfg, dt)
    mesh = generate_mesh(st.position, st.active, mcfg)
    img = render(inject_mesh(scene0, mesh.vertices, mesh.valid, water), cam, rcfg, HashDraws(seed),
                 device=scene0.device)
    return torch.mean(img.double()), diag, mesh


def lit_box(device, textured: bool):
    """The 16^3 composed gate's lit floor and lamp (tests/test_pixel_grad_fd.py)
    and its water."""
    b = SceneBuilder()
    white = b.lambertian((0.75, 0.75, 0.75))
    light = b.lambertian((0.8, 0.8, 0.8), emission=(60.0, 60.0, 60.0))
    water = b.lambertian((0.4, 0.55, 0.8), albedo_tex=b.add_texture(ramp_texels()) if textured else 0)
    b.add_mesh(np.array([[16, 0, 16], [0, 0, 16], [0, 0, 0], [16, 0, 0]], float), np.array([[0, 1, 2], [0, 2, 3]]),
               white)
    b.add_mesh(np.array([[11, 15.2, 11], [5, 15.2, 11], [5, 15.2, 5], [11, 15.2, 5]], float),
               np.array([[0, 2, 1], [0, 3, 2]]), light)
    cam = Camera.from_parameters((8.0, 10.0, 26.0), (8.0, 4.0, 8.0), (0.0, 1.0, 0.0), np.deg2rad(45.0), 1.0,
                                 device=device)
    return b.finish(device=device), water, cam


def pixel_grad_parity(device) -> None:
    """The composed pixel gradient (pixels -> render -> marching cubes ->
    two 16^3 substeps of 0.05 -> initial velocities) on the card (kernels
    A-F forward, B' D' F' and E' backward) against the CPU port (plain
    versions and their autograd), with the same substep and render draws:
    cosine >= 0.99, position correction off and on. Two substeps, where the
    gate has one, so that the gradient passes through P2G, the solve and
    G2P (see :func:`pixel_loss`). The water is textured and the image 16x16
    x 2 spp (3 bounces): at the gate's 8x8 x 2 spp with a plain water the
    gradient is zero on both sides (tests/test_torch_pixel_grad.py)."""
    rcfg = RenderConfig(width=16, height=16, samples_per_pixel=2, max_bounces=3, ray_batch=256)
    mcfg = MesherConfig(grid_size=(16, 16, 16), cell_size=1.0, grid_offset=(0.0, 0.0, 0.0), max_triangles=1 << 11)
    for correct in (False, True):
        cfg = SimConfig(grid_size=(16, 16, 16), cell_size=1.0, gravity=(0.0, -10.0, 0.0), particle_capacity=1 << 13,
                        scheme=TransferScheme.APIC, has_obstacles=False, enable_position_correction=correct)
        grads, losses = {}, {}
        for dev in (torch.device("cpu"), device):
            state = sim.seed_box(sim.new_state(cfg, dev), cfg, (5.0, 2.0, 5.0), (11.0, 6.0, 11.0))
            scene0, water, cam = lit_box(dev, True)
            vel = state.velocity.clone().requires_grad_()
            kernels.reset_launches()
            loss, _, _ = pixel_loss(cfg, state, vel, mcfg, scene0, water, cam, rcfg, 5, 0.05, substeps=2)
            (grads[dev.type],) = torch.autograd.grad(loss, vel)
            losses[dev.type] = float(loss.detach())
        launches = dict(kernels.LAUNCHES)
        need = ("p2g_bwd", "g2p_bwd", *MESH_GRAD_KERNELS) + (("correction_bwd",) if correct else ())
        for k in need:
            check(launches[k] > 0, f"pixel gradient parity: kernel {k} was not launched")
        g_dev, g_cpu = grads[device.type].cpu().double().flatten(), grads["cpu"].double().flatten()
        cos = float(torch.nn.functional.cosine_similarity(g_dev, g_cpu, dim=0))
        what = "correction on" if correct else "correction off"
        log(f"pixel gradient parity 16^3 ({what}), 2 substeps, 16x16 x 2 spp, textured water: loss card "
            f"{losses['cuda']:.6f} / cpu {losses['cpu']:.6f}, max|g| card {float(g_dev.abs().max()):.4e} / cpu "
            f"{float(g_cpu.abs().max()):.4e}, cosine {cos:.6f} (>= 0.99); gradient kernels' launches "
            + ", ".join(f"{k} {launches[k]}" for k in need))
        check(float(g_cpu.abs().max()) > 0 and bool(torch.isfinite(g_dev).all()), f"parity {what}: gradient zero")
        check(cos >= 0.99, f"pixel gradient parity ({what}): cosine {cos} < 0.99")


def pixel_grad_full_width(device) -> None:
    """Config 3's frame differentiably: the 64^3 APIC dam-break (capacity
    2^18, box (1,1,1)-(31,31,31), correction on), two substeps of 0.02 (so
    that the gradient passes through G2P, the pressure solve's adjoint and
    P2G: kernels D', B' and the adjoint CG, beside E' and F'),
    ``generate_mesh`` on 64^3 cells of 1.0 (2^17 triangles), ``inject_mesh``
    into the fluid box (no accelerator: the brute-force search, whose
    (rays, triangles) blocks autograd does not keep), ``render`` at 256^2 x
    1 spp, 3 bounces; loss the mean pixel, gradient with respect to the
    initial velocities. First with the plain water (the gradient is zero:
    no path weight depends on where a lambertian surface of constant albedo
    is hit), then with the water's albedo a ramp over the hit's uv: forward
    and backward ms, peak memory, |g|, the backward kernels' launches
    (p2g_bwd, g2p_bwd, correction_bwd, surface_keep, surface_bwd: each
    at least once); g finite and nonzero, and a step of
    max|dv| = 0.01 along -g lowers the loss, beside its first-order
    prediction, the loss recomputed at the same velocities (the float
    atomics' noise) and steps of 0.003 and 0.1 (printed, not held: a pixel
    whose path crosses a silhouette under the step moves the mean by
    ~5e-6, which autodiff does not see; at max|dv| 0.1 that outweighed the
    first-order change on the card)."""
    cfg = SimConfig(grid_size=(64, 64, 64), gravity=(0.0, -981.0, 0.0), particle_capacity=1 << 18,
                    scheme=TransferScheme.APIC, has_obstacles=False)
    state = sim.seed_box(sim.new_state(cfg, device), cfg, (1.0, 1.0, 1.0), (31.0, 31.0, 31.0))
    mcfg = MesherConfig(grid_size=(64, 64, 64), cell_size=1.0, max_triangles=1 << 17)
    rcfg = RenderConfig(width=256, height=256, samples_per_pixel=1, max_bounces=3, differentiable=True)
    for textured in (False, True):
        b, cam = scenes.fluid_box((0.0, 0.0, 0.0), (64.0, 64.0, 64.0), device=device)
        water = b.lambertian(WATER, albedo_tex=b.add_texture(ramp_texels()) if textured else 0)
        scene0 = b.finish(device=device)
        vel = state.velocity.clone().requires_grad_()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        loss, diag, mesh = pixel_loss(cfg, state, vel, mcfg, scene0, water, cam, rcfg, 3, DT, substeps=2)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        (g,) = torch.autograd.grad(loss, vel)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated()
        launches = {k: kernels.LAUNCHES[k] - before[k] for k in BACKWARD_KERNELS}
        gmax, gnorm = float(g.abs().max()), float(g.norm())
        what = "textured water" if textured else "plain water"
        check(bool(torch.isfinite(g).all()), f"config 3 pixel gradient ({what}): not finite")
        for k, n in launches.items():
            check(n > 0, f"config 3 pixel gradient ({what}): kernel {k} was not launched")
        text = (f"config 3 pixel gradient ({what}): two 64^3 substeps (CG {int(diag.pressure_iterations)} it in "
                f"the second) -> {int(mesh.count)} triangles -> 256^2 x 1 spp, 3 bounces, no accelerator: loss "
                f"{float(loss.detach()):.6f}, "
                f"forward {1e3 * (t1 - t0):.1f} ms, backward {1e3 * (t2 - t1):.1f} ms, peak memory "
                f"{peak / 2**30:.2f} GiB ({peak} B), |g| {gnorm:.6e}, max|g| {gmax:.6e}; gradient kernels' launches "
                + ", ".join(f"{k} {n}" for k, n in launches.items()))
        if not textured:
            log(text)
            continue
        check(gmax > 0, "config 3 pixel gradient (textured water): the gradient is zero")
        changes = {}
        with torch.no_grad():
            for step in (0.0, 0.003, 0.01, 0.1):
                moved, _, _ = pixel_loss(cfg, state, state.velocity - (step / gmax) * g, mcfg, scene0, water, cam,
                                         rcfg, 3, DT, substeps=2)
                changes[step] = float(moved) - float(loss.detach())
        log(f"{text}; the loss along -g, changed by (first-order prediction): "
            + ", ".join(f"max|dv| {step}: {changes[step]:.6e} ({-(step / gmax) * gnorm * gnorm:.6e})"
                        for step in changes))
        check(changes[0.01] < 0, f"config 3 pixel gradient: the loss rose by {changes[0.01]} along -g")


def voxelize_meshes(device, mesh128, mesh64) -> None:
    """``obstacle_cells`` of the 128^3 main path's mesh (closed: the mesher
    grid has a margin) onto the 128^3 grid on the card, with interior cells;
    then ``voxelize`` and ``obstacle_cells`` of config 3's mesh on the card
    and on the CPU, the surface, exterior and interior masks and the
    obstacle mask equal. That mesh is open where the fluid meets the
    mesher grid's edge, so the flood fill reaches every cell not on its
    surface and the interior is empty on both."""
    for what, n, (vertices, valid) in (("the 128^3 main path's mesh", 128, mesh128),
                                       ("config 3's 64^3 mesh", 64, mesh64)):
        cfg = SimConfig(grid_size=(n, n, n), particle_capacity=8)
        tris = vertices[valid].reshape(-1, 3)
        idx = torch.arange(tris.shape[0], device=tris.device).reshape(-1, 3)
        torch.cuda.synchronize()
        loops.reset_host_reads()
        t0 = time.perf_counter()
        mask = voxelizer.obstacle_cells(tris, idx, cfg, device)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        text = (f"voxelize {what} ({idx.shape[0]} triangles) onto {n}^3: {int(mask.sum())} interior cells, "
                f"{ms:.1f} ms on the card ({loops.HOST_READS['count']} host reads)")
        if n == 128:
            check(int(mask.sum()) > 0, f"voxelize {what}: no interior cell")
        else:
            vox = voxelizer.voxelize(tris, idx, 1.0, device=device)
            t0 = time.perf_counter()
            want = voxelizer.voxelize(tris.cpu(), idx.cpu(), 1.0, device="cpu")
            want_mask = voxelizer.obstacle_cells(tris.cpu(), idx.cpu(), cfg, "cpu")
            cpu_ms = 1e3 * (time.perf_counter() - t0)
            for field in ("surface", "exterior", "interior"):
                got = getattr(vox, field).cpu()
                check(torch.equal(got, getattr(want, field)), f"voxelize {what}: card and CPU {field} masks "
                      f"differ in {int((got != getattr(want, field)).sum())} cells")
            check(torch.equal(mask.cpu(), want_mask), f"voxelize {what}: card and CPU obstacle masks differ")
            check(int(vox.surface.sum()) > 0, f"voxelize {what}: no surface cell")
            text += (f"; voxelize: {int(vox.surface.sum())} surface, {int(vox.exterior.sum())} exterior, "
                     f"{int(vox.interior.sum())} interior cells, the four masks equal to the CPU port's "
                     f"({cpu_ms:.1f} ms there)")
        log(text)


def harness(device) -> None:
    """The small harness on the card: the DCC pipeline at setup 0's scale
    (50^3, 2^17 particles, the testbed's mesher) for 3 frames and a scrub
    back; a checkpoint of the 128^3 main path's state restored, one substep
    from each (positions within 1e-5 cells: the overflow scatter's float
    atomics may move the last bits); the native host library."""
    grid, mesher = dcc.create_simulation_pipeline(
        grid_kwargs=dict(grid_size=(50, 50, 50), particle_capacity=1 << 17, frames_per_second=60.0),
        mesher_cfg=testbed.default_mesher_config(), device=device)
    grid.add_seeder(lambda s, c: sim.seed_box(s, c, (15.0, 15.0, 15.0), (20.0, 20.0, 20.0)))
    t0 = time.perf_counter()
    grid.set_time(3)
    verts, count = mesher.evaluate()
    wall = time.perf_counter() - t0
    frame1 = grid._cache[1]
    grid.set_time(1)
    again = grid.evaluate()
    check(count > 0 and bool(np.isfinite(verts[:count]).all()), f"dcc: mesh of {count} triangles")
    check(len(grid._cache) == 4 and again is frame1, "dcc: the scrub back did not return the cached frame")
    log(f"dcc pipeline, setup 0 scale: 3 frames and the mesh ({count} triangles) in {wall:.2f} s; a scrub back "
        f"to frame 1 returned the cached frame ({again.shape[0]} particles), {len(grid._cache)} frames cached")
    del grid, mesher

    cfg, state = dam_break(128, device, 1 << 21)
    state, _ = sim.substep(state, cfg, DT)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.npz")
        t0 = time.perf_counter()
        checkpoint.save(path, state, metadata={"substeps": 1})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = checkpoint.restore(path, sim.new_state(cfg, device, 7), device=device)
        load_s = time.perf_counter() - t0
        size = os.path.getsize(path)
    a, _ = sim.substep(state, cfg, DT)
    b, _ = sim.substep(restored, cfg, DT)
    check(torch.equal(a.active, b.active), "checkpoint: active masks differ after a substep")
    err = max_err(a.position[a.active], b.position[b.active])
    log(f"checkpoint of the 128^3 state ({int(state.active.sum())} particles, {size} B): save {save_s:.2f} s, "
        f"restore {load_s:.2f} s; one substep from each: positions within {err:.3e} cells (< 1e-5)")
    check(err < 1e-5, f"checkpoint: positions differ by {err}")
    del state, restored, a, b

    check(native.available(), f"native: the host library did not build ({native._build_error})")
    with native.ExportPool(2) as pool:
        check(pool.native, "native: the export pool runs in Python")
        with tempfile.TemporaryDirectory() as d:
            pool.submit_obj(os.path.join(d, "mesh.obj"), verts[:count])
            pool.flush()
            check(pool.errors == 0, "native: the export pool reported errors")
    pos, idx, _ = native.weld_mesh(verts, count)
    log(f"native: {native._LIB_PATH} loaded, the export pool native; weld of {count} triangles -> "
        f"{pos.shape[0]} vertices, {idx.shape[0]} faces")


# BASELINE config 5: the 256^3 tide of bench.py:236-268 (slab-tiled there)
SLABS = 16


def config5_state(device):
    """bench.py's config 5: 256^3, h = 1, gravity -981, capacity 2^23,
    APIC, no obstacles; a floor layer and a column seeded at 8 a cell."""
    cfg = SimConfig(grid_size=(256, 256, 256), gravity=(0.0, -981.0, 0.0), particle_capacity=1 << 23,
                    scheme=TransferScheme.APIC, has_obstacles=False)
    state = sim.new_state(cfg, device)
    state = sim.seed_box(state, cfg, (1.0, 1.0, 1.0), (254.0, 9.0, 254.0))
    state = sim.seed_box(state, cfg, (1.0, 10.0, 1.0), (24.0, 63.0, 254.0))
    return cfg, state


def substep_peak(fn):
    """(result, host ms, peak bytes above what was allocated before, the
    absolute peak) of `fn`, synchronized."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    return out, ms, peak - base, peak


def config5(device) -> dict:
    """Config 5: a dense 256^3 substep from the seeded state (peak memory)
    and a second one from its result (ms); then the tiled substep from that
    same state with the same draws (a warm-up, held against the second
    dense substep row by row: both sort into the same rank-major order)
    and 3 timed tiled substeps. Returns the tiled run's launches."""
    t0 = time.perf_counter()
    cfg, state0 = config5_state(device)
    n0 = int(particle_count(state0))
    log(f"config 5 (256^3): seeded {n0} particles (capacity {cfg.particle_capacity}) in "
        f"{time.perf_counter() - t0:.1f} s")
    (dense1, ddiag), dense_ms, dense_above, dense_peak = substep_peak(
        lambda: sim.substep(state0, cfg, DT, sim.Draws(make_generator(5))))
    healthy(dense1, ddiag, cfg, n0, "config 5 dense substep")
    del state0
    (dense, ddiag), dense2_ms, _, dense2_peak = substep_peak(
        lambda: sim.substep(dense1, cfg, DT, sim.Draws(make_generator(6))))
    healthy(dense, ddiag, cfg, n0, "config 5 second dense substep")
    log(f"config 5 dense substeps: {dense_ms:.1f} ms (the first at 256^3, from rest), then {dense2_ms:.1f} ms, CG "
        f"{int(ddiag.pressure_iterations)} it res {float(ddiag.pressure_residual):.2e}, vmax "
        f"{float(ddiag.max_velocity):.2f}, overflow {int(ddiag.overflow_count)}; peak memory "
        f"{max(dense_peak, dense2_peak) / 2**30:.2f} GiB, the first {dense_above / 2**30:.2f} GiB above the "
        f"state ({max(dense_peak, dense2_peak)} B)")

    def tiled():
        (first, fdiag), warm_ms, first_above, first_peak = substep_peak(
            lambda: bigstep.substep_tiled(dense1, cfg, DT, SLABS, sim.Draws(make_generator(6))))
        healthy(first, fdiag, cfg, n0, "config 5 tiled warm-up substep")
        st, per, its, peaks = first, [], [], [first_peak]
        for i in range(3):
            (st, diag), ms, _, peak = substep_peak(lambda: bigstep.substep_tiled(st, cfg, DT, SLABS))
            healthy(st, diag, cfg, n0, f"config 5 tiled substep {i}")
            per.append(ms)
            its.append(int(diag.pressure_iterations))
            peaks.append(peak)
            log(f"config 5 tiled substep {i}: {ms:.1f} ms, CG {its[-1]} it res {float(diag.pressure_residual):.2e}, "
                f"vmax {float(diag.max_velocity):.2f}, n {int(diag.particle_count)}, overflow "
                f"{int(diag.overflow_count)}, uncorrected {int(diag.correction_uncorrected)}")
        log(f"config 5 tiled ({SLABS} slabs): warm-up {warm_ms:.1f} ms, {np.mean(per):.1f} ms/substep (mean of 3; "
            f"median {np.median(per):.1f}), CG {its} it; peak memory {max(peaks) / 2**30:.2f} GiB, the warm-up "
            f"{first_above / 2**30:.2f} GiB above the states it starts with ({max(peaks)} B)")
        return first, fdiag

    (first, fdiag), launches = drive("config 5 tiled path (4 substeps)", tiled, ("expand", "p2g", "correction", "g2p"))
    for name in ("expand", "p2g", "correction"):
        check(launches[name] == 4 * SLABS, f"config 5: {launches[name]} {name} launches, expected {4 * SLABS}")

    # the tiled substep against the dense one from the same state
    # (tests/test_bigstep.py's tolerances; rows in the same order)
    check(torch.equal(first.active, dense.active), "config 5: tiled and dense active rows differ")
    act = dense.active
    pos_err = max_err(first.position[act], dense.position[act])
    vel_ok = close(first.velocity[act], dense.velocity[act], 5e-3, 5e-3)
    face_ok = all(close(getattr(first.grid, f), getattr(dense.grid, f), 2e-3, 2e-3) for f in ("u", "v", "w"))
    ke = (float(fdiag.kinetic_energy), float(ddiag.kinetic_energy))
    log(f"config 5 tiled against dense, the second substep: position max error {pos_err:.2e} (<= 5e-4), "
        f"velocities within 5e-3 {vel_ok}, faces within 2e-3 {face_ok}, kinetic energy {ke[0]:.6e} / "
        f"{ke[1]:.6e}, CG {int(fdiag.pressure_iterations)} / {int(ddiag.pressure_iterations)} it")
    check(int(ddiag.pressure_iterations) > 0, "config 5: the compared substep's solve had no work")
    check(pos_err <= 5e-4 and vel_ok and face_ok, "config 5: tiled substep differs from the dense one")
    check(abs(ke[0] - ke[1]) <= 1e-3 * abs(ke[1]), "config 5: kinetic energies differ")
    check(int(fdiag.particle_count) == int(ddiag.particle_count) == n0, "config 5: particle counts differ")
    return launches


def nearest_rows(pos_a: torch.Tensor, pos_b: torch.Tensor, act_b: torch.Tensor, cfg, chunk: int = 1 << 16):
    """For each row of `pos_a`, the nearest active row of `pos_b` among its
    3x3x3 cells (``binning.gather_neighbors`` over `pos_b`'s cell-sorted
    runs, every particle of a cell): (index into `pos_b`, distance)."""
    bins = binning.bin_particles(pos_b, act_b, cfg)
    most = int(bins.cell_count.max())
    idx, dist_ = [], []
    for lo in range(0, pos_a.shape[0], chunk):
        a = pos_a[lo:lo + chunk]
        ids, valid = binning.gather_neighbors(bins, a, cfg, max_per_cell=most)
        ids = ids.long()
        d2 = ((pos_b[ids] - a[:, None, :]) ** 2).sum(-1)
        d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
        best, j = d2.min(dim=1)
        idx.append(torch.gather(ids, 1, j[:, None])[:, 0])
        dist_.append(torch.sqrt(best))
    return torch.cat(idx), torch.cat(dist_)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


PROXY_CELLS = [(0, y, z) for y in (20, 28, 36, 44) for z in (16, 24, 32, 40)]


def training_64(device, mesh):
    """dryrun_multichip's training step scaled to config 3's 64^3 dam-break:
    the box (1, 1, 1)-(31, 31, 31), and 16 proxy particles seeded one a cell
    on the x = 0 column (the lowest cell indices, so the substep's sort puts
    them first) in view on the left wall; the fluid box with 16 sphere
    proxies of radius 2 that emit a ramp over uv (dryrun's glass proxies
    give a zero gradient almost everywhere); 64^2 x 1 spp, 2 bounces, a
    black target, dt 1/60."""
    cfg = SimConfig(grid_size=(64, 64, 64), gravity=(0.0, -981.0, 0.0), particle_capacity=1 << 18,
                    scheme=TransferScheme.APIC, has_obstacles=False)
    state = sim.seed_box(sim.new_state(cfg, device), cfg, (1.0, 1.0, 1.0), (30.0, 30.0, 30.0))
    for cell in PROXY_CELLS:
        state = sim.seed_func(state, cfg, cell, (1, 1, 1), lambda p: np.ones(len(p), bool), density=1)
    b, cam = scenes.fluid_box((0.0, 0.0, 0.0), (64.0, 64.0, 64.0), aspect=1.0, device=device)
    # their emission a ramp over uv: the radiance depends on where a ray
    # hits them, so the pixel gradient does not vanish
    proxy = b.lambertian((0.8, 0.8, 0.8), emission=(4.0, 4.0, 4.0), emission_tex=b.add_texture(ramp_texels()))
    for _ in PROXY_CELLS:
        b.add_sphere(np.eye(3, 4), proxy)
    scene = b.finish(device=device)
    rcfg = RenderConfig(width=64, height=64, samples_per_pixel=1, max_bounces=2)
    target = torch.zeros((64, 64, 3), device=device)
    lr = 1e-2
    (new, loss), ms, above, peak = substep_peak(
        lambda: pshard.training_step(state, scene, cam, target, cfg, rcfg, mesh, 1.0 / 60.0, lr=lr,
                                     sphere_radius=2.0))
    grad = (state.velocity - new.velocity) / lr
    rows = int((grad.abs().sum(dim=1) > 0).sum())
    log(f"one-rank training step, 64^3 dam-break + 16 proxies, 64^2 x 1 spp: loss {float(loss):.6e}, |grad| "
        f"{float(torch.linalg.norm(grad)):.3e} on {rows} rows, {ms:.1f} ms forward and backward, peak "
        f"{peak / 2**30:.2f} GiB")
    check(bool(torch.isfinite(loss)), "training step: loss not finite")
    check(rows > 0 and bool(torch.isfinite(grad).all()), "training step: no gradient reached the velocities")


def sharded_phases(device) -> None:
    """The parallel layer on one rank: NCCL, world size 1, a rendezvous on
    127.0.0.1. The sharded substep of the 128^3 main-path state after one
    substep against the dense substep (a multiset: the sharded rows are in
    cell order), then step_z(1/60) from its result, then the training
    step."""
    pdist.init_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        mesh = pdist.global_mesh(("dp",))
        log(f"process group: backend {dist.get_backend()}, {pdist.process_count()} rank, mesh on {mesh.device}")
        cfg, state0 = dam_break(128, device, 1 << 21)
        n0 = int(particle_count(state0))
        # from the state after one substep, whose solve has work
        state0, _ = sim.substep(state0, cfg, DT, sim.Draws(make_generator(6)))
        dense, ddiag = sim.substep(state0, cfg, DT, sim.Draws(make_generator(7)))

        def one():
            t0 = time.perf_counter()
            share, diag = pshard.sharded_substep(state0, cfg, DT, mesh, sim.Draws(make_generator(7)))
            torch.cuda.synchronize()
            return share, diag, (time.perf_counter() - t0) * 1e3

        (share, zdiag, ms), _ = drive("one-rank sharded substep (128^3)", one,
                                      ("p2g", "correction", "g2p", "mg_coarse"))
        glob = zshard.gather_state(share, cfg, mesh)
        pa, va = glob.position[glob.active], glob.velocity[glob.active]
        pb, vb = dense.position, dense.velocity
        j, d = nearest_rows(pa, pb, dense.active, cfg)
        bijective = int(torch.unique(j).numel()) == pa.shape[0] == int(dense.active.sum())
        vel_err = max_err(va, vb[j])
        face_err = max(max_err(getattr(glob.grid, f), getattr(dense.grid, f)) for f in ("u", "v", "w"))
        # faces: test_zshard.py's 5e-4 and 1e-4 of the face; the two solves
        # stop at different iterates within the CG tolerance
        faces_ok = all(close(getattr(glob.grid, f), getattr(dense.grid, f), 1e-4, 5e-4) for f in ("u", "v", "w"))
        log(f"one-rank sharded substep: {ms:.1f} ms, CG {int(zdiag.pressure_iterations)} it (dense "
            f"{int(ddiag.pressure_iterations)}), n {int(zdiag.particle_count)}, lost {int(zdiag.particles_lost)}; "
            f"against the dense substep: nearest-row distance max {float(d.max()):.2e} (<= 2e-4), bijective "
            f"{bijective}, velocity max error {vel_err:.2e} (<= 5e-3), faces max error {face_err:.2e} (within "
            f"5e-4 + 1e-4 |face| {faces_ok})")
        check(bijective and float(d.max()) <= 2e-4 and vel_err <= 5e-3 and faces_ok,
              "one-rank sharded substep differs from the dense one")
        check(torch.equal(glob.grid.cell_type, dense.grid.cell_type), "sharded substep: cell types differ")
        # the sharded levels restrict and prolong piecewise constantly (the
        # JAX package's zshard), the dense cycle trilinearly: the iteration
        # counts need not agree, both solves must converge
        check(int(ddiag.pressure_iterations) > 0 and float(zdiag.pressure_residual) < 1e-5
              and int(zdiag.pressure_iterations) < 200, "sharded CG did not converge")
        check(int(zdiag.particle_count) == n0 and int(zdiag.particles_lost) == 0, "sharded substep lost particles")

        def cfl():
            t0 = time.perf_counter()
            st, diag = zshard.step_z(share, cfg, 1.0 / 60.0, mesh)
            torch.cuda.synchronize()
            return st, diag, (time.perf_counter() - t0) * 1e3

        (st, sdiag, ms), _ = drive("one-rank step_z(1/60)", cfl, ("p2g", "correction", "g2p", "mg_coarse"))
        log(f"one-rank step_z(1/60): {int(sdiag.substeps)} substeps in {ms:.1f} ms, CG "
            f"{int(sdiag.pressure_iterations)} it res {float(sdiag.pressure_residual):.2e}, n "
            f"{int(sdiag.particle_count)}, lost {int(sdiag.particles_lost)}")
        check(float(sdiag.pressure_residual) < 1e-5 and int(sdiag.particle_count) == n0
              and int(sdiag.particles_lost) == 0 and bool(torch.isfinite(st.position).all()), "step_z")
        del share, st, glob, dense, state0
        torch.cuda.empty_cache()
        # one substep: the loss reads positions, so the gradient passes
        # advection and the correction springs (E'), not P2G or G2P
        drive("one-rank training step (64^3)", lambda: training_64(device, mesh),
              ("expand", "p2g", "stencil", "g2p", "correction", "correction_bwd"))
    finally:
        dist.destroy_process_group()


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
    bf16_arithmetic(device)

    cfg, state = dam_break(128, device, 1 << 21)
    state, _ = sim.substep(state, cfg, DT)
    stats, cg_parts = kernel_phases(cfg, state)
    p2g_overflow_parity(cfg, state)
    stats.update(backward_kernel_phases(cfg, state))
    del state
    torch.cuda.empty_cache()

    drive("thin-grid path (128 x 64 x 8)", lambda: thin_grid(device),
          ("expand", "p2g", "stencil", "g2p", "correction"))
    # the path that still runs kernel stencil16: the mg16 cycle's bottom on
    # a level too large for one block
    _, thin16_launches = drive("thin-grid mg16 path (128 x 64 x 8)", lambda: thin_grid(device, "bfloat16"),
                               ("expand", "p2g", "stencil", "stencil16", "g2p", "correction"))
    slice_parity(device)
    scene_parity(device)
    drive("32^3 gradient parity (both scenes and the mesh)", lambda: grad_parity(device),
          ("expand", "p2g", "p2g_bwd", "stencil", "g2p", "g2p_bwd", "correction", "correction_bwd",
           *MESH_GRAD_KERNELS))
    descent_32(device)
    torch.cuda.empty_cache()
    mesh128, launches = drive("main path (128^3, correction on, mesh)",
                              lambda: dam_break_run(device, True, 5, cg_parts), FORWARD_KERNELS)
    check(launches["surface_keep"] == 0, "the main path's mesh (no gradient) kept the node sums")
    torch.cuda.empty_cache()
    drive("128^3 correction-off path", lambda: dam_break_run(device, False, 2),
          ("expand", "p2g", "stencil", *VCYCLE_KERNELS, "g2p"))
    torch.cuda.empty_cache()
    _, grad_launches = drive("128^3 gradient path", lambda: grad_run(device), GRAD_KERNELS)
    torch.cuda.empty_cache()
    _, corr_launches = drive("128^3 correction-on gradient path", lambda: grad_run_correction(device),
                             (*GRAD_KERNELS, "correction", "correction_bwd"))
    torch.cuda.empty_cache()
    _, mesh_launches = drive("261^3-node mesh gradient path", lambda: mesh_grad_run(device),
                             MESH_GRAD_KERNELS)
    torch.cuda.empty_cache()
    _, flip_launches = drive("128^3 FLIP + mg16 path", lambda: flip_run(device),
                             ("expand", "p2g", "stencil", *VCYCLE16_KERNELS))
    cycles = flip_launches["mg16_coarse"]
    fused16 = sum(flip_launches[k] for k in VCYCLE16_KERNELS)
    check(flip_launches["stencil16"] == 0 and fused16 <= 10 * cycles,
          f"the FLIP + mg16 path launched stencil16 or more than 10 kernels a cycle: {flip_launches}")
    torch.cuda.empty_cache()
    drive("testbed path (setup 4)", testbed_run, FORWARD_KERNELS)
    torch.cuda.empty_cache()
    renderer_phases(device, mesh128)
    del mesh128
    torch.cuda.empty_cache()
    drive("harness (DCC pipeline, checkpoint, native)", lambda: harness(device), FORWARD_KERNELS)
    torch.cuda.empty_cache()
    c5_launches = config5(device)
    torch.cuda.empty_cache()
    sharded_phases(device)

    # launches: each kernel's count on the path it belongs to (config 5's
    # tiled path, 4 substeps, for the kernels it launches: A, B, C and the
    # fused cycle, D, E; the main path for F, the gradient path for B' and
    # D', the correction-on gradient path for E', the mesh gradient path for
    # F's keep form and F', the FLIP + mg16 path for the fused bfloat16
    # cycle, the thin-grid mg16 path for the bfloat16 stencil)
    launches.update({k: v for k, v in c5_launches.items() if v > 0})
    launches.update({k: flip_launches[k] for k in VCYCLE16_KERNELS})
    launches.update(p2g_bwd=grad_launches["p2g_bwd"], g2p_bwd=grad_launches["g2p_bwd"],
                    stencil16=thin16_launches["stencil16"],
                    correction_bwd=corr_launches["correction_bwd"],
                    surface_keep=mesh_launches["surface_keep"],
                    surface_bwd=mesh_launches["surface_bwd"])
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
