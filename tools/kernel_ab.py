"""Two trees of the port on one card in one call: the fused V-cycle's
kernels, kernels B, F, D, D', B', E, E' and F', and the gradient runs that
take E' and F'.

The V-cycle part (``--vcycle`` runs it alone) comes first for each tree, in
a process of its own: on the 128^3 main path's hierarchy (the state one
substep from rest), on a 256^3 hierarchy (those cell types doubled along
each axis, config 5's grid), on testbed setup 4's 50^3 one (two
substeps from rest), on two thin slabs whose last level the coarse
kernel takes alone (80 x 72 x 16: in shared memory; 128 x 128 x 16: in
device memory) and on a thin slab with one fine level (96 x 81 x 15), in
float32 and in the bfloat16 of "mg16" (``chip_smoke.bf16_levels``): the
device's own ms (torch.profiler, median of 20 launches) of ``mg_pre`` /
``mg16_pre``, ``mg_restrict`` / ``mg16_restrict`` and ``mg_up`` /
``mg16_up`` at every level that takes them and of ``mg_coarse`` /
``mg16_coarse`` on the small levels, on the inputs the plain cycle gives
each stage; a whole cycle on the host clock and its
device busy ms; then ``pressure.solve`` of the 128^3 APIC substep and of
the FLIP + mg16 substep (the inputs ``substep`` gives it, captured once:
host ms and CG iterations), that substep under torch.profiler three times
from the same state and draws (device busy ms, host ms, CG iterations) and
five substeps of each path (host ms and CG iterations a substep). Each stage's output, each cycle's and each solve's
pressure are saved in a temporary directory, so that the last line says
whether all four runs gave the same bits.

Runs this file's measurement in a process of its own for each tree, in the
order parent, change, change, parent (two calls may land on two cards, so
two versions compare only inside one call), and prints one line a turn: the
event-median ms of kernel B (``kernels.p2g_faces``) and of kernel F with its
binning (``surface.sample_surface``, ``surface.bin_particles``) at the 128^3
main path's shapes, three medians each, and the host-clock ms of the
``p2g_slots`` stage, of ``generate_mesh`` and of five substeps; then, on a
line of its own, kernels D (``transfers.g2p_pic``) and D'
(``transfers.g2p_bwd``): three event medians around the wrapper, the
device's own time of the kernel (torch.profiler), and the host-clock ms of
the ``g2p_pic`` stage (a call and a synchronize); then kernel B'
(``kernels.p2g_faces_bwd``) likewise; then kernel E
(``kernels.correction_springs``) on the resident slots, three event medians
and its device time; last, the gradients: kernel E'
(``kernels.correction_springs_bwd``) on the resident slots, with the count
of their ordered pairs closer than re (the only pairs whose terms are not
exact zeros) and the float time of those pairs' terms, and at 32 slots a
cell on a 64^3 grid of random slots, three event medians and the device
time of each kernel it launched; F' through the public path, the
261^3-node ``surface.sample_surface`` of positions that want a gradient and
``torch.autograd.grad`` of it (the forward with and without a gradient and
the backward: three event medians each, the device time of each surface
kernel launched, the backward's peak memory), its positions and result
saved in a temporary directory so that the last line says whether the two
trees' F' had the same inputs and gave the same bits; ``generate_mesh``
without a gradient (wall ms, peak); the mesh gradient of
``chip_smoke.mesh_grad_run`` five times in one process (forward and
backward wall ms, and the device's busy ms in one more backward); then each
tree's ``chip_smoke.grad_run_correction`` and ``chip_smoke.mesh_grad_run``
(forward and backward ms, peak memory). Everything after the five substeps
is measured on the state one substep from rest, as the substeps leave it.

Run from the repository root on a machine with an H100, with the parent
commit unpacked beside it (``git archive <commit> libfluid_tpu_torch
chip_smoke.py | tar -x -C <dir>``):

    python3 tools/kernel_ab.py [--vcycle] <dir of the parent tree>
"""

import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np


def fmt(xs):
    return " ".join(f"{x:.4f}" for x in xs)


def device_split(fn, match: str, calls: int = 20) -> dict:
    """The device's own ms a launch of each CUDA kernel whose name contains
    `match`, from torch.profiler over `calls` calls of `fn`: {kernel: (median
    ms, launches the profiler reported)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name:
            name = re.search(r"(\w+(<[^()]*>)?)\(", e.name)
            by.setdefault(name.group(1) if name else e.name[:60], []).append(e.device_time_total / 1e3)
    return {k: (round(float(np.median(v)), 4), len(v)) for k, v in by.items()}


def vcycle_part(tag: str, out: str) -> None:
    """The V-cycle part for the tree in the current directory (see the
    module's docstring); the outputs go to the folder `out`."""
    sys.path.insert(0, os.getcwd())
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from libfluid_tpu_torch import _build, convert, sim, testbed
    from libfluid_tpu_torch.sim import multigrid as mg
    from libfluid_tpu_torch.sim import pressure

    _build.load()
    dev = torch.device("cuda")
    cfg, state = cs.dam_break(128, dev, 1 << 21)
    # the inputs of the first run, for all four: a substep's sums are not the
    # same bits from run to run
    inputs = os.path.join(out, "inputs.pt")
    if os.path.exists(inputs):
        arrays, ct50 = torch.load(inputs, weights_only=False)
        state = convert.state_from_numpy(arrays, cfg, dev)
        ct50 = ct50.to(dev)
    else:
        state, _ = sim.substep(state, cfg, cs.DT)
        tcfg, tstate = testbed.build_setup(4, device=dev)
        for _ in range(2):
            tstate, _ = sim.substep(tstate, tcfg, 0.005)
        ct50 = tstate.grid.cell_type
        del tstate
        torch.save((convert.state_to_numpy(state), ct50.cpu()), inputs)
    ct = state.grid.cell_type
    hierarchies = {
        "128^3": ct,
        "256^3": ct.repeat_interleave(2, 0).repeat_interleave(2, 1).repeat_interleave(2, 2),
        "50^3": ct50,
        "80x72x16 slab": slab((80, 72, 16), dev),
        "128x128x16 slab": slab((128, 128, 16), dev),
        "96x81x15 slab": slab((96, 81, 15), dev),
    }
    saved = {}
    for hname, cell_type in hierarchies.items():
        for dname, levels in (("float32", mg.build_levels(cell_type)),
                              ("bfloat16", cs.bf16_levels(mg.build_levels(cell_type)))):
            dtype = levels[0].fluid.dtype
            gen = torch.Generator(device=dev).manual_seed(2)
            b = (20.0 * torch.randn(levels[0].fluid.shape, generator=gen, device=dev)).to(dtype) * levels[0].fluid
            first = mg.first_coarse_level(levels)
            parts, bs = [], [b]
            for l in range(first):
                lv, lc, bl = levels[l], levels[l + 1], bs[l]
                shape = tuple(lv.fluid.shape)
                x = mg._pre_torch(lv, bl)
                bs.append(mg._restrict_residual_torch(lv, lc, x, bl))
                for stage, fused, want in (
                        ("pre", lambda: mg.pre_smooth(lv, bl), x),
                        ("restrict", lambda: mg.restrict_residual(lv, lc, x, bl), bs[-1])):
                    got = fused()
                    saved[f"{hname} {dname} {stage} {l}"] = got.cpu()
                    equal = torch.equal(got, want)
                    ms = device_split(fused, f"mg_{stage}")
                    parts.append(f"{stage} {shape} {fmt_device(ms)}{'' if equal else ' (not equal to plain)'}")
                ec = mg._coarse_torch(levels, bs[-1], l + 1)
                got = mg.prolong_smooth(lv, x, ec, bl)
                saved[f"{hname} {dname} up {l}"] = got.cpu()
                equal = torch.equal(got, mg._up_torch(lv, x, ec, bl))
                ms = device_split(lambda: mg.prolong_smooth(lv, x, ec, bl), "mg_up_kernel")
                parts.append(f"up {shape} {fmt_device(ms)}{'' if equal else ' (not equal to plain)'}")
                del x, ec, got
            bc = bs[first]
            got = mg.coarse_cycle(levels, bc, first)
            saved[f"{hname} {dname} coarse"] = got.cpu()
            equal = torch.equal(got, mg._coarse_torch(levels, bc, first))
            ms = device_split(lambda: mg.coarse_cycle(levels, bc, first), "mg_coarse_kernel")
            parts.append(f"coarse {[tuple(lv.fluid.shape) for lv in levels[first:]]} {fmt_device(ms)}"
                         f"{'' if equal else ' (not equal to plain)'}")
            saved[f"{hname} {dname} cycle"] = mg.v_cycle(levels, b).cpu()
            wall = [cs.wall_ms(lambda: mg.v_cycle(levels, b)) for _ in range(3)]
            busy = device_busy(lambda: mg.v_cycle(levels, b))
            print(f"{tag}: V-cycle {hname} {dname}: " + " | ".join(parts)
                  + f" | cycle wall ms {fmt(wall)}, device busy {busy:.4f} ms", flush=True)
            del levels, bs, b, bc, got
        torch.cuda.empty_cache()
    del hierarchies
    # the solve and five substeps of each 128^3 path, from the state one
    # substep from rest
    for pname, pcfg in (("APIC", cfg), ("FLIP + mg16", cs.flip_mg16(cfg))):
        captured = []
        solve = pressure.solve

        def grab(*a, **k):
            captured.append((a, k))
            return solve(*a, **k)

        draws = state.generator.get_state()
        pressure.solve = grab
        try:
            sim.substep(state, pcfg, cs.DT)
        finally:
            pressure.solve = solve
            state.generator.set_state(draws)
        a, k = captured[0]
        res = solve(*a, **k)
        saved[f"{pname} solve"] = res.pressure.cpu()
        solve_ms = [cs.wall_ms(lambda: solve(*a, **k), 3) for _ in range(3)]
        del captured, a, k
        # the substep from this state under torch.profiler, three times from
        # the same draws: device busy ms, wall ms and CG iterations of each
        busy, walls, its = [], [], []
        for _ in range(3):
            state.generator.set_state(draws)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                _, diag = sim.substep(state, pcfg, cs.DT)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            busy.append(sum(e.device_time_total for e in prof.events()
                            if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3)
            its.append(int(diag.pressure_iterations))
        state.generator.set_state(draws)
        print(f"{tag}: 128^3 {pname}: a profiled substep from the state, three times: device busy ms "
              f"{fmt(busy)}, wall ms {fmt(walls)}, CG iterations {its}", flush=True)
        steps, its, ahead = [], [], state
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ahead, diag = sim.substep(ahead, pcfg, cs.DT)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
            its.append(int(diag.pressure_iterations))
        saved[f"{pname} substeps"] = ahead.position.cpu()
        del ahead
        print(f"{tag}: 128^3 {pname}: pressure.solve wall ms {fmt(solve_ms)} at {int(res.iterations)} CG "
              f"iterations | five substeps ms {fmt(steps)}, CG iterations {its}", flush=True)
    torch.save(saved, os.path.join(out, f"vcycle_{tag}_{os.getpid()}.pt"))


def slab(shape, device):
    """Cell types of a thin slab, made from a seed: a solid floor, fluid at
    random in the lower two thirds, air above."""
    import torch

    from libfluid_tpu_torch.config import CellType

    rng = np.random.default_rng(4)
    ct = np.full(shape, int(CellType.AIR), np.int8)
    ct[:, 0, :] = int(CellType.SOLID)
    fluid = rng.uniform(size=shape) < 0.7
    fluid[:, 2 * shape[1] // 3:, :] = False
    ct[fluid & (ct == int(CellType.AIR))] = int(CellType.FLUID)
    return torch.from_numpy(ct).to(device)


def fmt_device(by: dict) -> str:
    return ", ".join(f"device {ms:.4f} ms ({n} launches)" for ms, n in by.values()) or "device not measured"


def device_busy(fn, calls: int = 20) -> float:
    """The device's busy ms a call of `fn` (the sum of its kernels' and
    copies' times, torch.profiler, over `calls` calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / calls


def measure(tag: str, out: str) -> None:
    """The tree in the current directory; F''s result goes to the folder `out`."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from libfluid_tpu_torch import _build, sim
    from libfluid_tpu_torch.mesher import generate_mesh, surface
    from libfluid_tpu_torch.sim import kernels, slotsort, transfers

    _build.load()
    cfg, state = cs.dam_break(128, torch.device("cuda"), 1 << 21)
    state, _ = sim.substep(state, cfg, cs.DT)
    rs = slotsort.sort_rank_major(state, cfg)
    data = slotsort.expand(rs.payT, rs.ins, rs.counts).reshape(
        16, cfg.max_neighbors_per_cell, *cfg.grid_size)
    del rs
    b = [cs.median_ms(lambda: kernels.p2g_faces(data, cfg)) for _ in range(3)]
    del data
    pos, act, mesher = state.position, state.active, cs.MESH_128
    f = [cs.median_ms(lambda: surface.sample_surface(pos, act, mesher)) for _ in range(3)]
    binning = [cs.median_ms(lambda: surface.bin_particles(pos, act, mesher)) for _ in range(3)]
    sb = slotsort.sort_and_build(state, cfg)
    st = sb.state

    def stage():
        return transfers.p2g_slots(sb.slot_grid, st.position, st.velocity, st.affine, st.active,
                                   cfg, overflow_start=sb.n_kept)

    p2g_slots = [cs.wall_ms(stage, 10) for _ in range(3)]
    mesh = [cs.wall_ms(lambda: generate_mesh(pos, act, mesher), 5) for _ in range(3)]
    substeps, ahead = [], state
    for _ in range(6):  # the first is left out
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ahead, _ = sim.substep(ahead, cfg, cs.DT)
        torch.cuda.synchronize()
        substeps.append((time.perf_counter() - t0) * 1e3)
    del ahead

    print(f"{tag}: B ms {fmt(b)} | F ms {fmt(f)} (binning {fmt(binning)}) | p2g_slots wall ms "
          f"{fmt(p2g_slots)} | mesh wall ms {fmt(mesh)} | substeps ms {fmt(substeps[1:])}", flush=True)

    grid, pos = state.grid, state.position.contiguous()
    gen = torch.Generator(device=pos.device).manual_seed(1)
    gv = torch.randn((pos.shape[0], 3), generator=gen, device=pos.device)
    ga = torch.randn((pos.shape[0], 3, 3), generator=gen, device=pos.device)

    def forward():
        return transfers.g2p_pic(grid, pos, cfg)

    def backward():
        return transfers.g2p_bwd(grid.u, grid.v, grid.w, pos, gv, ga, cfg)

    d = [cs.median_ms(forward) for _ in range(3)]
    db = [cs.median_ms(backward) for _ in range(3)]
    stage = [cs.wall_ms(forward, 1) for _ in range(5)]
    print(f"{tag}: D ms {fmt(d)} (device {cs.device_ms(forward, 'g2p_kernel')}) | D' ms {fmt(db)} "
          f"(device {cs.device_ms(backward, 'g2p_bwd_kernel')}) | g2p_pic stage wall ms {fmt(stage)}",
          flush=True)

    # kernel B' on the payload of this state and random face cotangents
    data = slotsort.sort_and_build(state, cfg).slot_grid.data.contiguous()
    faces = [torch.randn(sh, generator=gen, device=pos.device) for sh in kernels.face_shapes(cfg) * 2]

    def p2g_backward():
        return kernels.p2g_faces_bwd(data, faces[:3], faces[3:], cfg)

    bb = [cs.median_ms(p2g_backward) for _ in range(3)]
    print(f"{tag}: B' ms {fmt(bb)} (device {cs.device_ms(p2g_backward, 'p2g_bwd_kernel')})", flush=True)
    del data, faces

    # kernel E on this state's resident slots
    sg = slotsort.sort_and_build(state, cfg).slot_grid
    kc = min(cfg.correction_capacity, sg.capacity)
    res_pos, res_mask = sg.position[:, :kc].contiguous(), sg.mask[:kc].contiguous()
    del sg

    def springs():
        return kernels.correction_springs(res_pos, res_mask, cfg.cell_size**2 / 2.0, 12345)

    e = [cs.median_ms(springs) for _ in range(3)]
    print(f"{tag}: E ms {fmt(e)} (device {cs.device_ms(springs, 'correction_kernel')})", flush=True)
    del res_pos, res_mask
    torch.cuda.empty_cache()
    gradients(tag, cs, cfg, state, out)


def gradients(tag: str, cs, cfg, state, out: str) -> None:
    """E' on the resident slots of `state` (the 128^3 main path's after one
    substep) and at 32 slots a cell; F' through the public path on its
    particles; the tree's two full-width gradient runs."""
    import torch

    from libfluid_tpu_torch.mesher import generate_mesh, surface
    from libfluid_tpu_torch.sim import kernels, slotsort

    device = state.position.device
    gen = torch.Generator(device=device).manual_seed(2)
    sg = slotsort.sort_and_build(state, cfg).slot_grid
    kc = min(cfg.correction_capacity, sg.capacity)
    res_pos, res_mask = sg.position[:, :kc].contiguous(), sg.mask[:kc].contiguous()
    del sg
    g = torch.randn(res_pos.shape, generator=gen, device=device)
    re2 = cfg.cell_size**2 / 2.0

    def springs_bwd():
        return kernels.correction_springs_bwd(res_pos, res_mask, g, re2, 12345)

    eb = [cs.median_ms(springs_bwd) for _ in range(3)]
    near = pairs_in_reach(res_pos, res_mask, re2, cfg)
    print(f"{tag}: E' ms {fmt(eb)} (device {device_split(springs_bwd, 'correction_bwd')}); {near} ordered pairs "
          f"closer than re, their terms at 45 float operations each {45.0 * near / cs.FP32_FLOP_PER_S * 1e3:.4f} ms",
          flush=True)
    del res_pos, res_mask, g

    # kernel E' at 32 slots a cell: 4 in 10 slots occupied, a point in its cell
    shape = (64, 64, 64)
    mask = (torch.rand((32, *shape), generator=gen, device=device) < 0.4).float()
    cell = torch.stack(torch.meshgrid(
        *(torch.arange(n, device=device, dtype=torch.float32) for n in shape), indexing="ij"))
    slots = (cell[:, None] + torch.rand((3, 32, *shape), generator=gen, device=device)) * mask
    g32 = torch.randn(slots.shape, generator=gen, device=device)

    def springs_bwd32():
        return kernels.correction_springs_bwd(slots, mask, g32, 0.5, 12345)

    e32 = [cs.median_ms(springs_bwd32) for _ in range(3)]
    print(f"{tag}: E' at 32 slots a cell on {shape} ms {fmt(e32)} (device "
          f"{device_split(springs_bwd32, 'correction_bwd')})", flush=True)
    del mask, cell, slots, g32
    torch.cuda.empty_cache()

    # F' through the public path: the forward of positions that want a
    # gradient, then torch.autograd.grad of it
    mesher = cs.MESH_128
    act = state.active
    leaf = state.position.detach().clone().requires_grad_()
    gn = torch.randn(tuple(n + 1 for n in mesher.grid_size), generator=gen, device=device)

    def forward():
        return surface.sample_surface(leaf, act, mesher)

    def forward_no_grad():
        with torch.no_grad():
            return surface.sample_surface(leaf, act, mesher)

    fg = [cs.median_ms(forward) for _ in range(3)]
    fn = [cs.median_ms(forward_no_grad) for _ in range(3)]
    sdf = forward()

    def backward():
        return torch.autograd.grad(sdf, leaf, gn, retain_graph=True)[0]

    fb = [cs.median_ms(backward) for _ in range(3)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dx = backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    torch.save((leaf.detach().cpu(), dx.cpu()), os.path.join(out, f"{tag}_{os.getpid()}.pt"))
    print(f"{tag}: F' (261^3 nodes) forward with a gradient ms {fmt(fg)} (device {device_split(forward, 'surface')}), "
          f"without {fmt(fn)} (device {device_split(forward_no_grad, 'surface')}); backward ms {fmt(fb)} (device "
          f"{device_split(backward, 'surface')}), its peak above what was allocated {peak / 2**20:.1f} MiB", flush=True)
    del sdf, leaf, dx
    torch.cuda.empty_cache()
    # the mesh without a gradient: its time and its peak above what was allocated
    mesh_ms = [cs.wall_ms(lambda: generate_mesh(state.position, act, mesher), 3) for _ in range(3)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        generate_mesh(state.position, act, mesher)
    torch.cuda.synchronize()
    print(f"{tag}: generate_mesh without a gradient wall ms {fmt(mesh_ms)}, its peak above what was allocated "
          f"{(torch.cuda.max_memory_allocated() - base) / 2**20:.1f} MiB", flush=True)
    torch.cuda.empty_cache()
    mesh_gradients(tag, cs, state)
    torch.cuda.empty_cache()
    cs.grad_run_correction(device)
    torch.cuda.empty_cache()
    cs.mesh_grad_run(device)


def pairs_in_reach(res_pos, res_mask, re2: float, cfg) -> int:
    """The ordered pairs of occupied slots (a slot not with itself) of the 27
    neighbour cells that lie closer than re: the pairs whose terms in the
    springs and their VJP are not exact zeros. One target slot row at a time,
    so that no (KC, KC, cells) array is made."""
    import torch

    from libfluid_tpu_torch.sim import slots

    occ = res_mask != 0
    total = 0
    for d in slots.NEIGHBOR_OFFSETS:
        other = slots.shifted(res_pos, d, cfg)
        other_occ = slots.shifted(res_mask, d, cfg) != 0
        for i in range(res_mask.shape[0]):
            sq = sum((res_pos[a, i][None] - other[a]) ** 2 for a in range(3))
            near = (sq < re2) & other_occ & occ[i][None]
            if tuple(d) == (0, 0, 0):
                near[i] = False
            total += int(near.sum())
        del other, other_occ
    torch.cuda.empty_cache()
    return total


def mesh_gradients(tag: str, cs, state, reps: int = 5) -> None:
    """The mesh gradient of ``chip_smoke.mesh_grad_run`` (``generate_mesh``
    of positions that want a gradient, ``chip_smoke.mesh_loss``,
    ``torch.autograd.grad``) `reps` times: the host-clock ms of each forward
    and backward, then the device's busy ms (the sum of its kernels' and
    copies' times, torch.profiler) in one more backward."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from libfluid_tpu_torch.mesher import generate_mesh

    act = state.active

    def forward():
        leaf = state.position.detach().clone().requires_grad_()
        return leaf, cs.mesh_loss(generate_mesh(leaf, act, cs.MESH_128))

    fwd, bwd = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        leaf, loss = forward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.autograd.grad(loss, leaf)
        torch.cuda.synchronize()
        bwd.append((time.perf_counter() - t1) * 1e3)
        fwd.append((t1 - t0) * 1e3)
        del leaf, loss
    leaf, loss = forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(loss, leaf)
        torch.cuda.synchronize()
    busy = sum(e.device_time_total for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f"{tag}: mesh gradient x{reps} forward wall ms {fmt(fwd)} (median {float(np.median(fwd)):.4f}), "
          f"backward wall ms {fmt(bwd)} (median {float(np.median(bwd)):.4f}); one more backward: device busy "
          f"{busy:.4f} ms", flush=True)
    del leaf, loss


def main() -> None:
    args = sys.argv[1:]
    if len(args) == 3 and args[0] in ("--measure", "--measure-vcycle"):
        (measure if args[0] == "--measure" else vcycle_part)(args[1], args[2])
        return
    vcycle_only = args[:1] == ["--vcycle"]
    args = args[1:] if vcycle_only else args
    if len(args) != 1:
        raise SystemExit(__doc__)
    parent = args[0]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    me = os.path.abspath(__file__)
    out = tempfile.mkdtemp()
    modes = ["--measure-vcycle"] if vcycle_only else ["--measure-vcycle", "--measure"]
    for tag, cwd in (("parent", parent), ("change", "."), ("change", "."), ("parent", parent)):
        for mode in modes:
            subprocess.run([sys.executable, me, mode, tag, out], cwd=cwd, check=True)
    import torch

    saved = {name: torch.load(os.path.join(out, name)) for name in sorted(os.listdir(out)) if name != "inputs.pt"}
    shutil.rmtree(out)
    cycles = [v for k, v in saved.items() if k.startswith("vcycle_")]
    first = [k for k in cycles[0] if not k.endswith("substeps")]
    print(f"V-cycle part: {len(cycles)} runs from the same inputs, their {len(first)} stage, cycle and "
          f"solve outputs all the same bits: {all(torch.equal(c[k], cycles[0][k]) for c in cycles for k in first)}; "
          f"the states after five substeps: "
          f"{[all(torch.equal(c[k], cycles[0][k]) for c in cycles) for k in cycles[0] if k.endswith('substeps')]}",
          flush=True)
    runs = [v for k, v in saved.items() if not k.startswith("vcycle_")]
    if runs:
        print(f"F' of the 261^3 mesh: {len(runs)} runs, their positions all the same bits: "
              f"{all(torch.equal(runs[0][0], x) for x, _ in runs)}, their results all the same bits: "
              f"{all(torch.equal(runs[0][1], dx) for _, dx in runs)}", flush=True)


if __name__ == "__main__":
    main()
