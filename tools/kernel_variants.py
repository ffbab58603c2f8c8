"""Kernels B (``csrc/p2g.cu``), F (``csrc/surface.cu``), D, D', B' and E' in other shapes.

Builds each kernel again from its source with the tile shape and the chunk
size replaced in the text, or with one part switched off (its loop bounds
made empty by a condition the compiler cannot see through), loads each
build under a name of its own, and times it at the 128^3 main path's shapes:
two event medians and the device's own time (torch.profiler). A build that
computes everything must give the bits of the library's kernel, whatever
its tile. Then the pieces of ``surface.bin_particles`` one by one, beside
the two ways of making the bin starts that were not taken.

Kernels D (``csrc/g2p.cu``) and D' (``csrc/g2p_bwd.cu``) come first, with
other block sizes and one part switched off at a time; ``--g2p`` stops after
them, and ``--parent <tree>`` does the same for the sources of another tree
(the kernels as they were before their redesign, whose text the
``*_OLD_PARTS`` tables match) and nothing else.

``--backward`` does kernels B' (``csrc/p2g_bwd.cu``: its zero fill as a
kernel or as cudaMemsetAsync, the pass over the occupied slots with all 54
faces a slot or one part switched off at a time, other tiles and register
budgets) and E' (``csrc/correction_bwd.cu``: ``rsqrtf``, no cull, one or
four i's at a time, another tile, one or eight tiles a block, and the
kernel cut short after its zeros and staging, or without its pair loop)
and nothing else; ``--backward --parent <tree>`` times B' as another tree has it.

Run from the repository root on a machine with an H100:

    python3 tools/kernel_variants.py [--g2p | --parent <tree> | --backward [--parent <tree>]]
"""

import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from libfluid_tpu_torch import _build, sim  # noqa: E402
from libfluid_tpu_torch.mesher import surface  # noqa: E402
from libfluid_tpu_torch.sim import kernels, slotsort, transfers  # noqa: E402

# kernel B: the line of the tile, the line of the chunk, and the parts
B_TILE = "constexpr int TX = 4, TY = 16, TZ = 16, THREADS = TY * TZ;"
B_CAP = "constexpr int CAP = 1024; "
B_SHAPES = [(4, 16, 16, 1024), (4, 8, 16, 512), (4, 16, 16, 768), (4, 16, 16, 1536), (6, 16, 16, 1024),
            (3, 16, 16, 1024), (8, 16, 16, 1024), (2, 8, 16, 512), (4, 8, 32, 1024), (4, 16, 8, 512)]
B_PARTS = {
    "no face sums": ("if ((p + 1) * PLANE_CELLS <= c0 || p * PLANE_CELLS >= c1) continue;",
                     "if (K > 0 || (p + 1) * PLANE_CELLS <= c0 || p * PLANE_CELLS >= c1) continue;"),
    "no loads of the slots": ("t < ncell * most; t += THREADS", "t < ncell * most * (K < 0); t += THREADS"),
    "every tile as if empty": ("if (!seen) {", "if (!seen || K > 0) {"),
}
# kernel F
F_TILE = "constexpr int TX = 8, TY = 8, TZ = 8;  // nodes a tile"
F_CAP = "constexpr int CAP = 3584; "
F_SHAPES = [(8, 8, 8, 3584), (8, 8, 8, 2048), (8, 8, 8, 1024), (4, 8, 8, 2048), (8, 4, 8, 2048),
            (8, 8, 4, 2560), (8, 8, 16, 5632), (16, 8, 8, 5632)]
F_PARTS = {
    "no sums": ("if (rb[(lx + 1) * wy] <= e0 || rb[lx * wy] >= e1) continue;",
                "if (cr > 0 || rb[(lx + 1) * wy] <= e0 || rb[lx * wy] >= e1) continue;"),
    "every tile as if empty": ("  // 2. each row's place",
                               "  if (cr > 0) { if (inside) *node = 1.0f; return; }\n  // 2. each row's place"),
    "particle loop not unrolled": ("#pragma unroll 2\n        for (int e = lo; e < hi; ++e) {",
                                   "#pragma unroll 1\n        for (int e = lo; e < hi; ++e) {"),
}


def build(source: str, swaps, tag: str, folder: str, csrc=_build.CSRC):
    """The library of `source` (in the folder `csrc`) with each (old, new) of
    `swaps` replaced in its text, and what ptxas says of its registers and
    spills."""
    text = (Path(csrc) / source).read_text()
    for old, new in swaps:
        if old not in text:
            raise RuntimeError(f"{source} has no {old!r}")
        text = text.replace(old, new)
    path = os.path.join(folder, tag)
    with open(path + ".cu", "w") as f:
        f.write(text)
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
                           path + ".so", path + ".cu"], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"{tag}: nvcc failed\n{done.stderr[-2000:]}")
    said = [line.split(":", 1)[-1].strip() for line in done.stderr.splitlines()
            if "registers" in line or "spill" in line]
    return ctypes.CDLL(path + ".so"), "; ".join(said)


def run(source, entry, kernel, variants, args, outs, want, folder, csrc=_build.CSRC, zero=()) -> None:
    """Build, check and time each variant; the tensors of `zero` are set to
    0 before every launch (a kernel that accumulates into them)."""
    stream = torch.cuda.current_stream().cuda_stream
    for n, (what, swaps) in enumerate(variants):
        lib, said = build(source, swaps, f"{entry}_{n}", folder, csrc)
        fn = getattr(lib, entry)
        fn.argtypes = _build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
        cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]

        def call():
            for z in zero:
                z.zero_()
            err = fn(*cargs, stream)
            if err != 0:
                raise RuntimeError(f"{entry} ({what}): CUDA error {err}")

        for o in outs:
            o.fill_(-7.0)
        call()
        torch.cuda.synchronize()
        same = all(torch.equal(o, w) for o, w in zip(outs, want))
        worst = max((cs.max_err(o, w) for o, w in zip(outs, want) if o.numel()), default=0.0)
        ms = [cs.median_ms(call) for _ in range(2)]
        names = (kernel,) if isinstance(kernel, str) else kernel
        device = ", ".join(f"{name} {cs.device_ms(call, name)}" for name in names)
        print(f"{entry} {what}: ms {ms[0]:.4f} {ms[1]:.4f}, device {device}, "
              f"the library's bits: {same} (max abs difference {worst:.3e}); {said}", flush=True)


# kernels D and D' as they were before their redesign (one thread a particle
# over 54 face samples, the weights inside the innermost loop): the parts of
# the parent's sources, for ``--parent <tree>``
D_OLD_PARTS = {
    "as built": [],
    "no face loads": [("const float sample = arr[((long long)ix * fy + iy) * fz + iz];",
                       "const float sample = h;")],
    "no arithmetic": [("val += n0 * n1 * n2 * sample;", "val += sample;"),
                      ("g0 += s0 * n1 * n2 / h * sample;", "g0 += sample;"),
                      ("g1 += n0 * s1 * n2 / h * sample;", "g1 += sample;"),
                      ("g2 += n0 * n1 * s2 / h * sample;", "g2 += sample;")],
    "no stores": [("vel[3 * p + a] = val;", "if (val != 12345.678f) continue;\n    vel[3 * p + a] = val;")],
    "divisions as one multiplication": [
        ("/ h * sample", "* rh * sample"),
        ("const int dims[3] = {nx, ny, nz};", "const int dims[3] = {nx, ny, nz};\n  const float rh = 1.0f / h;")],
}
_NO_ATOMICS = ("if (gs != 0.0f) atomicAdd(garr + f, gs);", "if (gs == 12345.678f) atomicAdd(garr + f, gs);")
_NO_GPOS = ("if (S == 0.0f) continue;", "if (S != 12345.678f) continue;")
DB_OLD_PARTS = {
    "as built": [],
    "no atomics": [_NO_ATOMICS],
    "no face loads": [("const float S = arr[f];", "const float S = h;")],
    "no position-cotangent arithmetic": [_NO_GPOS],
    "no atomics, no position-cotangent arithmetic": [_NO_ATOMICS, _NO_GPOS],
    "no loads of the cotangents": [("gvel[3 * p + a]", "h"), ("gaff[9 * p + 3 * a] / h", "h / h"),
                                   ("gaff[9 * p + 3 * a + 1] / h", "h / h"),
                                   ("gaff[9 * p + 3 * a + 2] / h", "h / h")],
}


# kernels D and D' as they are: the block size, and the parts
G_THREADS = "constexpr int THREADS = 128;"
_ALL_THREE = ("if (ax.triple || ay.triple || az.triple)", "if (n > 0)")
D_PARTS = {
    "as built": [],
    "64 threads a block": [(G_THREADS, "constexpr int THREADS = 64;")],
    "256 threads a block": [(G_THREADS, "constexpr int THREADS = 256;")],
    "windows of three for every particle (54 loads)": [_ALL_THREE],
    "no face loads": [("const float sample = __ldg(row + tz.idx[k]);", "const float sample = (float)tz.idx[k];")],
    "no multiply-adds a sample": [("sn += tz.n[k] * sample;", "sn += sample;"),
                                  ("ss += tz.s[k] * sample;", "ss += sample;")],
    "staging by 4-byte loads and stores": [
        ("const int vec = aligned16(pos) | aligned16(vel) << 1 | aligned16(aff) << 2;", "const int vec = 0;")],
    "each thread stores its own 12 words": [
        ("  stage_out<THREADS>(vel + 3 * start, sm_vel, 3 * count, vec & 2);\n"
         "  stage_out<THREADS>(aff + 9 * start, sm_aff, 9 * count, vec & 4);",
         "  if (t < count) {\n"
         "    for (int q = 0; q < 3; ++q) vel[3 * (start + t) + q] = sm_vel[3 * t + q];\n"
         "    for (int q = 0; q < 9; ++q) aff[9 * (start + t) + q] = sm_aff[9 * t + q];\n  }")],
    "no stores": [("  stage_out<THREADS>(vel + 3 * start, sm_vel, 3 * count, vec & 2);",
                   "  if (n > 0) return;\n  stage_out<THREADS>(vel + 3 * start, sm_vel, 3 * count, vec & 2);")],
}
_ATOMIC = "if (gs != 0.0f) add_to<BOXED>(out + tz.idx[k], gs);"
DB_SHAPE = ("constexpr int THREADS = 128;", "constexpr int ROUNDS = 2; ", "constexpr int BOX = 4096; ",
            "constexpr int MIN_BLOCKS = 5; ")
# threads a block, particles a thread, floats of the box, blocks an SM the registers are held to
DB_SHAPES = [(128, 2, 4096, 5), (128, 2, 6144, 5), (128, 2, 5120, 5), (128, 2, 4608, 5), (128, 2, 3584, 5),
             (128, 2, 3072, 5), (128, 2, 2048, 5), (128, 2, 4096, 4), (128, 2, 4096, 6), (64, 4, 4096, 8),
             (128, 1, 2048, 5), (256, 1, 4096, 2), (128, 3, 6144, 5), (128, 4, 7168, 5), (256, 4, 14336, 2)]


def _db_shape(threads, rounds, box, blocks):
    return [(DB_SHAPE[0], f"constexpr int THREADS = {threads};"), (DB_SHAPE[1], f"constexpr int ROUNDS = {rounds}; "),
            (DB_SHAPE[2], f"constexpr int BOX = {box}; "), (DB_SHAPE[3], f"constexpr int MIN_BLOCKS = {blocks}; ")]


DB_PARTS = {
    **{f"{t} threads, {r} particles a thread, box of {b} floats, registers for {m} blocks an SM":
       _db_shape(t, r, b, m) for t, r, b, m in DB_SHAPES},
    "no box: every particle adds straight into device memory": [
        ("const bool boxed = 9 * plane <= BOX;", "const bool boxed = n < 0;")],
    "the box never written back": [("  if (!boxed) return;", "  if (n > 0) return;")],
    "windows of three for every particle": [
        ("const bool three = ax.triple || ay.triple || az.triple;", "const bool three = n > 0;")],
    "no atomics": [(_ATOMIC, "if (gs == 12345.678f) add_to<BOXED>(out + tz.idx[k], gs);")],
    "no face loads": [("const float S = __ldg(row + tz.idx[k]);", "const float S = (float)tz.idx[k];")],
    "staging by 4-byte loads and stores": [
        ("const int vec = aligned16(pos) | aligned16(gpos) << 1;", "const int vec = 0;")],
}


def g2p_variants(state, cfg, d_parts, db_parts, folder, csrc=_build.CSRC) -> None:
    """Kernels D and D' of the sources in `csrc`, each part of `d_parts` and
    `db_parts` switched off in turn, on the 128^3 state's faces and
    particles; D' with the face cotangents zeroed before every launch (the
    event medians include those three fills, the device's own time does
    not)."""
    grid, pos = state.grid, state.position.contiguous()
    n = pos.shape[0]
    nx, ny, nz = cfg.grid_size
    tail = (n, nx, ny, nz, float(cfg.cell_size), *(float(o) for o in cfg.grid_offset))
    want = transfers.g2p_pic(grid, pos, cfg)
    outs = [torch.empty_like(t) for t in want]
    run("g2p.cu", "lf_g2p", "g2p_kernel", list(d_parts.items()),
        (grid.u, grid.v, grid.w, pos, *outs, *tail), outs, want, folder, csrc)
    gen = torch.Generator(device=pos.device).manual_seed(1)
    gvel = torch.randn((n, 3), generator=gen, device=pos.device)
    gaff = torch.randn((n, 3, 3), generator=gen, device=pos.device)
    want = transfers.g2p_bwd(grid.u, grid.v, grid.w, pos, gvel, gaff, cfg)
    outs = [torch.zeros_like(t) for t in want]
    run("g2p_bwd.cu", "lf_g2p_bwd", "g2p_bwd_kernel", list(db_parts.items()),
        (grid.u, grid.v, grid.w, pos, gvel, gaff, *outs, *tail), outs, want, folder, csrc, zero=outs[:3])


# kernel B': its fill, its parts, its tile, its register budget
BB_FILL = "fill_kernel<<<FILL_BLOCKS, FILL_THREADS, 0, st>>>(reinterpret_cast<float4*>(out), total * 4);"
BB_TILE = "constexpr int TX = 2, TY = 2, TZ = 32, THREADS = TX * TY * TZ;"
BB_BOUNDS = "__launch_bounds__(THREADS)\np2g_bwd_kernel("
_BB_NO_FACES = [("if (wide) {", "if (K < 0) {"),
                ("slot_faces<2>(tb, box, ic, st,", "if (K < 0) slot_faces<2>(tb, box, ic, st,")]
BB_PARTS = {
    "as built (a fill with 16-byte stores, then the pass)": [],
    "cudaMemsetAsync, then the pass": [
        (BB_FILL, "cudaMemsetAsync(out, 0, (size_t)total * 16 * sizeof(float), st);")],
    "every tile as if empty (the fill and the masks)": [
        ("if (!__syncthreads_or(any)) return;", "if (!__syncthreads_or(any) || K > 0) return;")],
    "all 54 faces a slot": [("wide |= !dead_lo && !dead_hi;", "wide |= K > 0;")],
    "no face arithmetic": _BB_NO_FACES,
    "no face arithmetic, no loads of a slot's rows 4 to 15": [
        *_BB_NO_FACES, ("(use_affine || r < 3) ? data[(4 + r) * col + s] : 0.0f", "(float)r")],
    "no stores of the occupied slots": [
        ("    out[3 * col + s] = sum.m;", "    if (sum.m != 12345.678f) continue;\n    out[3 * col + s] = sum.m;"),
        ("for (int q = 0; q < 3; ++q) out[q * col + s] = sum.t[q] / h + sum.x[q];",
         "for (int q = 0; q < 3; ++q) if (sum.m == 12345.678f) out[q * col + s] = sum.t[q] / h + sum.x[q];")],
    **{f"registers for {m} blocks an SM":
       [(BB_BOUNDS, f"__launch_bounds__(THREADS, {m})\np2g_bwd_kernel(")] for m in (3, 4)},
    **{f"tile {tx} x {ty} x {tz}": [(BB_TILE, f"constexpr int TX = {tx}, TY = {ty}, TZ = {tz}, THREADS = TX * TY * TZ;")]
       for tx, ty, tz in ((1, 4, 32), (2, 4, 32), (4, 4, 32), (2, 8, 32), (2, 4, 16), (4, 4, 16), (1, 2, 64), (1, 2, 32))},
}
# kernel E'
EB_PARTS = {
    "as built": [],
    "rsqrtf (with its fix-up for denormals)": [("const float rs = coincide ? 0.0f : rsqrt_normal(sq);",
                                                "const float rs = coincide ? 0.0f : rsqrtf(sq);")],
    "every j kept (no cull)": [("dx * dx + dy * dy + dz * dz < cut2;",
                                "(dx * dx + dy * dy + dz * dz < cut2 || re2 > 0.0f);")],
    "the i's one at a time": [("constexpr int IG = 2;", "constexpr int IG = 1;")],
    "the i's four at a time": [("constexpr int IG = 2;", "constexpr int IG = 4;")],
    "the 4 x 4 x 4 tile": [("constexpr int TX = 2, TY = 4, TZ = 8;", "constexpr int TX = 4, TY = 4, TZ = 4;")],
    "one tile a block": [("constexpr int TILES = 4;", "constexpr int TILES = 1;")],
    "eight tiles a block": [("constexpr int TILES = 4;", "constexpr int TILES = 8;")],
    "the zeros and the staging only": [("      // 3. a warp a cell of the tile\n", "      if (KC > 0) continue;\n")],
    "no pair loop (the box, the cull, the tree, the writes)": [
        ("for (int v = lane; v < kept; v += 32) {", "for (int v = lane; v < kept && re2 < 0.0f; v += 32) {")],
}


def backward_variants(state, cfg, folder, csrc=_build.CSRC, parent=False) -> None:
    """Kernel B' on the 128^3 payload and random face cotangents, kernel E'
    on the 128^3 resident slots and a random cotangent; with `parent`, B' of
    the sources in `csrc` as built and nothing else."""
    dev = state.position.device
    gen = torch.Generator(device=dev).manual_seed(1)
    nx, ny, nz = cfg.grid_size
    sg = slotsort.sort_and_build(state, cfg).slot_grid
    data = sg.data.contiguous()
    faces = [torch.randn(sh, generator=gen, device=dev) for sh in kernels.face_shapes(cfg) * 2]
    want = kernels.p2g_faces_bwd(data, faces[:3], faces[3:], cfg)
    out = torch.empty_like(want)
    ox, oy, oz = (float(o) for o in cfg.grid_offset)
    parts = {"as the parent built it": []} if parent else BB_PARTS
    run("p2g_bwd.cu", "lf_p2g_bwd", ("fill_kernel", "Memset", "p2g_bwd_kernel"), list(parts.items()),
        (data, *faces, out, data.shape[1], nx, ny, nz, float(cfg.cell_size), ox, oy, oz, 1),
        [out], [want], folder, csrc)
    del out, want, faces
    if parent:
        return
    kc = min(cfg.correction_capacity, sg.capacity)
    res_pos, res_mask = sg.position[:, :kc].contiguous(), sg.mask[:kc].contiguous()
    del sg, data
    g = torch.randn(res_pos.shape, generator=gen, device=dev)
    want = kernels.correction_springs_bwd(res_pos, res_mask, g, cfg.cell_size**2 / 2.0, 12345)
    outs = [torch.empty_like(t) for t in want]
    run("correction_bwd.cu", "lf_correction_bwd", "correction_bwd_kernel", list(EB_PARTS.items()),
        (res_pos, res_mask, g, *outs, kc, nx, ny, nz, cfg.cell_size**2 / 2.0, 12345, 0, 0, 0),
        outs, want, folder)


def binning_pieces(pos, act, mesher) -> None:
    dev = pos.device
    cr = surface._support_cells(mesher)
    dims = [n + 2 * cr for n in mesher.grid_size]
    pdims = torch.tensor(dims, dtype=torch.int32, device=dev)
    n_bins = dims[0] * dims[1] * dims[2]
    off = torch.tensor(mesher.grid_offset, dtype=pos.dtype, device=dev)

    def keys():
        pb = torch.floor((pos - off) / mesher.cell_size).to(torch.int32) + cr
        ok = act & torch.all((pb >= 0) & (pb < pdims), dim=-1)
        bins = (pb[:, 0] * pdims[1] + pb[:, 1]) * pdims[2] + pb[:, 2]
        return torch.where(ok, bins, torch.full_like(bins, n_bins))

    bins = keys()
    bins_s, order = torch.sort(bins, stable=True)
    probe = torch.arange(n_bins + 1, dtype=torch.int32, device=dev)

    def scatter_cumsum():  # as bin_particles has it
        counts = torch.zeros((n_bins + 2,), dtype=torch.int32, device=dev)
        counts.index_add_(0, bins + 1, torch.ones_like(bins))
        return torch.cumsum(counts[: n_bins + 1], dim=0, dtype=torch.int32)

    def bincount_cumsum():  # as it was
        counts = torch.bincount(bins_s, minlength=n_bins + 1)[:n_bins]
        starts = torch.zeros((n_bins + 1,), dtype=torch.int32, device=dev)
        starts[1:] = torch.cumsum(counts, dim=0)
        return starts

    def searchsorted():
        return torch.searchsorted(bins_s, probe, out_int32=True)

    want = scatter_cumsum()
    for what, fn in (("bin keys", keys), ("stable sort", lambda: torch.sort(bins, stable=True)),
                     ("starts by int32 scatter + cumsum", scatter_cumsum),
                     ("starts by bincount + cumsum (not taken)", bincount_cumsum),
                     ("starts by searchsorted (not taken)", searchsorted),
                     ("gather of the positions", lambda: pos[order].contiguous()),
                     ("bin_particles", lambda: surface.bin_particles(pos, act, mesher))):
        print(f"binning, {what}: {cs.median_ms(fn):.4f} ms", flush=True)
    if not (torch.equal(bincount_cumsum(), want) and torch.equal(searchsorted(), want)):
        raise RuntimeError("the three ways of making the bin starts differ")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _build.load()
    dev = torch.device("cuda")
    cfg, state = cs.dam_break(128, dev, 1 << 21)
    state, _ = sim.substep(state, cfg, cs.DT)
    if sys.argv[1:2] == ["--backward"]:
        with tempfile.TemporaryDirectory() as folder:
            if sys.argv[2:3] == ["--parent"]:
                backward_variants(state, cfg, folder, Path(sys.argv[3]) / "libfluid_tpu_torch" / "csrc", True)
            else:
                backward_variants(state, cfg, folder)
        return
    if len(sys.argv) == 3 and sys.argv[1] == "--parent":
        with tempfile.TemporaryDirectory() as folder:
            g2p_variants(state, cfg, D_OLD_PARTS, DB_OLD_PARTS, folder,
                         Path(sys.argv[2]) / "libfluid_tpu_torch" / "csrc")
        return
    with tempfile.TemporaryDirectory() as folder:
        g2p_variants(state, cfg, D_PARTS, DB_PARTS, folder)
    if sys.argv[1:] == ["--g2p"]:
        return
    rs = slotsort.sort_rank_major(state, cfg)
    nx, ny, nz = cfg.grid_size
    data = slotsort.expand(rs.payT, rs.ins, rs.counts).reshape(16, cfg.max_neighbors_per_cell, nx, ny, nz)
    del rs
    with tempfile.TemporaryDirectory() as folder:
        num, den = kernels.p2g_faces(data, cfg)
        outs = [torch.empty_like(t) for t in (*num, *den)]
        ox, oy, oz = (float(o) for o in cfg.grid_offset)
        variants = [(f"tile {tx} x {ty} x {tz}, {cap} slots a chunk",
                     [(B_TILE, f"constexpr int TX = {tx}, TY = {ty}, TZ = {tz}, THREADS = TY * TZ;"),
                      (B_CAP, f"constexpr int CAP = {cap};")]) for tx, ty, tz, cap in B_SHAPES]
        variants += [(what, [swap]) for what, swap in B_PARTS.items()]
        run("p2g.cu", "lf_p2g", "p2g_kernel", variants,
            (data, *outs, data.shape[1], nx, ny, nz, float(cfg.cell_size), ox, oy, oz, 1),
            outs, (*num, *den), folder)
        del data, num, den, outs

        pos, act, mesher = state.position, state.active, cs.MESH_128
        want = surface.sample_surface(pos, act, mesher)
        pos_s, starts, _ = surface.bin_particles(pos, act, mesher)
        out = torch.empty_like(want)
        mx, my, mz = mesher.grid_size
        ox, oy, oz = (float(o) for o in mesher.grid_offset)
        variants = [(f"tile {tx} x {ty} x {tz}, {cap} particles a chunk",
                     [(F_TILE, f"constexpr int TX = {tx}, TY = {ty}, TZ = {tz};"),
                      (F_CAP, f"constexpr int CAP = {cap};")]) for tx, ty, tz, cap in F_SHAPES]
        variants += [(what, [swap]) for what, swap in F_PARTS.items()]
        run("surface.cu", "lf_surface", "surface_kernel", variants,
            (pos_s, starts, out, mx, my, mz, surface._support_cells(mesher), float(mesher.cell_size),
             ox, oy, oz, float(mesher.particle_extent) ** 2, float(mesher.particle_radius)),
            [out], [want], folder)
    binning_pieces(pos, act, mesher)


if __name__ == "__main__":
    main()
