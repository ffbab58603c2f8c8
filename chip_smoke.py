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
   median time of both;
4. a seeded 32^3 dam-break with position correction off, and a 32^3 scene
   with the default options (position correction, a solid block, a
   source), each run for 2 substeps on the card (kernels) and on the CPU
   (plain versions) and compared; the second is then meshed, compared;
5. the main path: the 128^3 APIC dam-break with position correction on
   (~2.0M particles), one warm-up substep, 5 timed substeps, one CFL
   ``step(1/60)``, then ``generate_mesh`` on the 260^3-cell mesher grid,
   with the healthy-output checks and the launch counts;
6. the same dam-break with position correction off, 2 substeps;
7. the testbed CLI, setup 4 (jet source + obstacle), 2 frames with an OBJ
   export every frame.

Every path is driven with the launch counts set to 0 just before it and
read just after; each fails if a kernel of its path was not launched. Any
failed check raises, so the script exits non-zero and prints no result.
The line before the last holds the per-kernel JSON record (launches of the
main path); the last line is ``{"ok": true, "device": {...}}``. Needs a
CUDA device; never falls back to the CPU for the main path.
"""

import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from libfluid_tpu_torch import _build
from libfluid_tpu_torch.config import MesherConfig, SimConfig, TransferScheme
from libfluid_tpu_torch import sim
from libfluid_tpu_torch.io.obj import load_obj
from libfluid_tpu_torch.mesher import generate_mesh, surface
from libfluid_tpu_torch.sim import correction, kernels, multigrid, slotsort, sources, transfers
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
}
DT = 0.02  # the dam-break substep of the JAX package's benchmark
REPS = 10
PLAIN_REPS_SLOW = 3  # repetitions of the plain correction and surface passes
# the testbed mesher's parameters (cell 0.5, extent 2.0, radius 0.5, offset
# -1) with the grid scaled to the 128^3 domain as 104 cells cover 50
MESH_128 = MesherConfig(
    grid_size=(260, 260, 260), cell_size=0.5, grid_offset=(-1.0, -1.0, -1.0),
    particle_extent=2.0, particle_radius=0.5, max_triangles=1 << 21,
)


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
    mcfg = MesherConfig(grid_size=(66, 66, 66), cell_size=0.5, grid_offset=(-1.0, -1.0, -1.0),
                        particle_extent=2.0, particle_radius=0.5, max_triangles=1 << 18)
    runs = {}
    for dev in (device, torch.device("cpu")):
        cfg, state = parity_scene(dev)
        for _ in range(2):
            state, diag = sim.substep(state, cfg, DT)
        sdf = surface.sample_surface(state.position, state.active, mcfg)
        mesh = generate_mesh(state.position, state.active, mcfg)
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
    del state
    torch.cuda.empty_cache()

    slice_parity(device)
    scene_parity(device)
    _, launches = drive("main path (128^3, correction on, mesh)",
                        lambda: dam_break_run(device, True, 5, True), KERNELS)
    torch.cuda.empty_cache()
    drive("128^3 correction-off path", lambda: dam_break_run(device, False, 2, False),
          ("expand", "p2g", "stencil", "g2p"))
    torch.cuda.empty_cache()
    drive("testbed path (setup 4)", testbed_run, KERNELS)

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
