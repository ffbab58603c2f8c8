"""Two trees of the port on one card in one call: kernels B, F, D, D', B', E,
E' and F'.

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
(``kernels.p2g_faces_bwd``) likewise; then kernels E
(``kernels.correction_springs``) and E' (``kernels.correction_springs_bwd``)
on the resident slots and F' (``surface.sample_surface_bwd``, both
launches) on the 261^3-node grid, three event medians each and the
device's own time of E and E'; last, E' at 32 slots a cell on a 64^3 grid
of random slots.

Run from the repository root on a machine with an H100, with the parent
commit unpacked beside it (``git archive <commit> libfluid_tpu_torch
chip_smoke.py | tar -x -C <dir>``):

    python3 tools/kernel_ab.py <dir of the parent tree>
"""

import os
import subprocess
import sys
import time


def measure(tag: str) -> None:
    """The tree in the current directory."""
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
    substeps = []
    for _ in range(6):  # the first is left out
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = sim.substep(state, cfg, cs.DT)
        torch.cuda.synchronize()
        substeps.append((time.perf_counter() - t0) * 1e3)

    def fmt(xs):
        return " ".join(f"{x:.4f}" for x in xs)

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

    # kernels E and E' on this state's resident slots, F' on its particles
    sg = slotsort.sort_and_build(state, cfg).slot_grid
    kc = min(cfg.correction_capacity, sg.capacity)
    res_pos, res_mask = sg.position[:, :kc].contiguous(), sg.mask[:kc].contiguous()
    del sg
    g = torch.randn(res_pos.shape, generator=gen, device=pos.device)
    re2 = cfg.cell_size**2 / 2.0

    def springs():
        return kernels.correction_springs(res_pos, res_mask, re2, 12345)

    def springs_bwd():
        return kernels.correction_springs_bwd(res_pos, res_mask, g, re2, 12345)

    binned = surface._binned(pos, state.active, mesher)
    gn = torch.randn(tuple(n + 1 for n in mesher.grid_size), generator=gen, device=pos.device)

    def surface_bwd():
        return surface.sample_surface_bwd(binned, gn, mesher)

    e = [cs.median_ms(springs) for _ in range(3)]
    eb = [cs.median_ms(springs_bwd) for _ in range(3)]
    fb = [cs.median_ms(surface_bwd) for _ in range(3)]
    print(f"{tag}: E ms {fmt(e)} (device {cs.device_ms(springs, 'correction_kernel')}) | E' ms {fmt(eb)} "
          f"(device {cs.device_ms(springs_bwd, 'correction_bwd_kernel')}) | F' ms {fmt(fb)} (device: node "
          f"part {cs.device_ms(surface_bwd, 'surface_kernel')}, particle part "
          f"{cs.device_ms(surface_bwd, 'surface_bwd_kernel')})", flush=True)
    del res_pos, res_mask, g, binned

    # kernel E' at 32 slots a cell: 4 in 10 slots occupied, a point in its cell
    shape = (64, 64, 64)
    mask = (torch.rand((32, *shape), generator=gen, device=pos.device) < 0.4).float()
    cell = torch.stack(torch.meshgrid(
        *(torch.arange(n, device=pos.device, dtype=torch.float32) for n in shape), indexing="ij"))
    slots = (cell[:, None] + torch.rand((3, 32, *shape), generator=gen, device=pos.device)) * mask
    g32 = torch.randn(slots.shape, generator=gen, device=pos.device)

    def springs_bwd32():
        return kernels.correction_springs_bwd(slots, mask, g32, 0.5, 12345)

    e32 = [cs.median_ms(springs_bwd32) for _ in range(3)]
    print(f"{tag}: E' at 32 slots a cell on {shape} ms {fmt(e32)} (device "
          f"{cs.device_ms(springs_bwd32, 'correction_bwd')})", flush=True)


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        measure(sys.argv[2])
        return
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    parent = sys.argv[1]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    me = os.path.abspath(__file__)
    for tag, cwd in (("parent", parent), ("change", "."), ("change", "."), ("parent", parent)):
        subprocess.run([sys.executable, me, "--measure", tag], cwd=cwd, check=True)


if __name__ == "__main__":
    main()
