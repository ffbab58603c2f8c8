"""Two trees of the port on one card in one call: kernels B, F, D, D', B', E,
E' and F', and the gradient runs that take E' and F'.

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

    python3 tools/kernel_ab.py <dir of the parent tree>
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
    if len(args) == 3 and args[0] == "--measure":
        measure(args[1], args[2])
        return
    if len(args) != 1:
        raise SystemExit(__doc__)
    parent = args[0]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    me = os.path.abspath(__file__)
    out = tempfile.mkdtemp()
    for tag, cwd in (("parent", parent), ("change", "."), ("change", "."), ("parent", parent)):
        subprocess.run([sys.executable, me, "--measure", tag, out], cwd=cwd, check=True)
    import torch

    runs = [torch.load(os.path.join(out, name)) for name in sorted(os.listdir(out))]
    shutil.rmtree(out)
    print(f"F' of the 261^3 mesh: {len(runs)} runs, their positions all the same bits: "
          f"{all(torch.equal(runs[0][0], x) for x, _ in runs)}, their results all the same bits: "
          f"{all(torch.equal(runs[0][1], dx) for _, dx in runs)}", flush=True)


if __name__ == "__main__":
    main()
