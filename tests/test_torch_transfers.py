"""Parity of the PyTorch port's P2G (kernel B's plain version, a numpy
model of its tile algorithm, and the overflow scatter) and G2P (kernel D's
plain version) with the JAX package.

Tolerances are those of the JAX package's own Pallas-vs-oracle tests: P2G
faces within 2e-5 of the largest face value after normalization, G2P within
rtol/atol 1e-5."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu import grids
from libfluid_tpu.config import SimConfig, TransferScheme
from libfluid_tpu.sim import binning as binning_mod
from libfluid_tpu.sim import slots as slots_mod
from libfluid_tpu.sim import slotsort, transfers
from libfluid_tpu.sim.state import new_state
from libfluid_tpu_torch import convert
from libfluid_tpu_torch import grids as t_grids
from libfluid_tpu_torch.sim import kernels as t_kernels
from libfluid_tpu_torch.sim import slots as t_slots
from libfluid_tpu_torch.sim import slotsort as t_slotsort
from libfluid_tpu_torch.sim import transfers as t_transfers

torch.set_num_threads(1)

SCHEMES = [TransferScheme.APIC, TransferScheme.PIC]


def _t(x):
    return torch.from_numpy(np.array(x))


def _normalized_err(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want)) / (np.max(np.abs(want)) + 1e-9))


def _crammed(scheme):
    """The fixture of test_transfers.test_p2g_slots_exact_under_overflow,
    drawn with numpy: 200 particles in one cell (far past K), the rest
    spread over an 8^3 domain."""
    cfg = SimConfig(grid_size=(8, 8, 8), particle_capacity=1 << 12, scheme=scheme)
    rng = np.random.default_rng(5)
    n = cfg.particle_capacity
    pos = np.concatenate([
        rng.uniform(1.1, 1.9, (200, 3)), rng.uniform(0.5, 7.5, (n - 200, 3))
    ]).astype(np.float32)
    vel = rng.standard_normal((n, 3)).astype(np.float32)
    aff = (rng.standard_normal((n, 3, 3)) * 0.1).astype(np.float32)
    state = new_state(cfg, jax.random.PRNGKey(5))._replace(
        position=jnp.asarray(pos), velocity=jnp.asarray(vel),
        affine=jnp.asarray(aff), active=jnp.ones((n,), bool),
    )
    return cfg, convert.config_from_fields(**vars(cfg)), state


@pytest.mark.parametrize("scheme", SCHEMES)
def test_p2g_slots_under_overflow_matches_jax(scheme):
    """JAX's binning-path slot grid (nonzero compaction of the overflow
    rows), fed to both packages' p2g_slots."""
    cfg, tcfg, state = _crammed(scheme)
    state, bins = binning_mod.sort_by_cell(state, cfg)
    sg = slots_mod.build(state.position, state.velocity, state.affine, bins, cfg)
    assert int(jnp.sum(sg.overflow)) > 0
    want = transfers.p2g_slots(
        sg, state.position, state.velocity, state.affine, state.active, cfg
    )
    tsg = t_slots.SlotGrid(data=_t(sg.data), slot_of=_t(sg.slot_of), overflow=_t(sg.overflow))
    got = t_transfers.p2g_slots(
        tsg, _t(state.position), _t(state.velocity), _t(state.affine),
        _t(state.active), tcfg,
    )
    for g, w in zip(got, want):
        assert _normalized_err(g, w) < 2e-5


@pytest.mark.parametrize("scheme", SCHEMES)
def test_p2g_slots_overflow_window_matches_jax(scheme):
    """The substep's path: slotsort's slot grid and its contiguous overflow
    window (``overflow_start``)."""
    cfg, tcfg, state = _crammed(scheme)
    sb = slotsort.sort_and_build(state, cfg)
    st = sb.state
    want = transfers.p2g_slots(
        sb.slot_grid, st.position, st.velocity, st.affine, st.active, cfg,
        overflow_start=sb.n_kept,
    )
    s = jax.tree_util.tree_map(np.asarray, state)
    tstate = convert.state_from_numpy(
        dict(position=s.position, velocity=s.velocity, affine=s.affine,
             active=s.active, u=s.grid.u, v=s.grid.v, w=s.grid.w,
             cell_type=s.grid.cell_type, solid=s.solid, pressure=s.pressure,
             time=s.time),
        tcfg, "cpu",
    )
    tsb = t_slotsort.sort_and_build(tstate, tcfg)
    ts = tsb.state
    got = t_transfers.p2g_slots(
        tsb.slot_grid, ts.position, ts.velocity, ts.affine, ts.active, tcfg,
        overflow_start=tsb.n_kept,
    )
    for g, w in zip(got, want):
        assert _normalized_err(g, w) < 2e-5


@pytest.mark.parametrize("scheme", SCHEMES)
def test_p2g_face_sums_match_jax_oracle(scheme):
    """Kernel B's plain version (through its wrapper, CPU tensors) against
    ``transfers._p2g_slots_jnp`` on a random payload whose slots are not
    prefix-dense, on an odd grid with an offset and a non-unit cell size."""
    cfg = SimConfig(
        grid_size=(7, 5, 6), cell_size=0.7, grid_offset=(0.3, -0.2, 0.1),
        scheme=scheme, max_neighbors_per_cell=5,
    )
    nx, ny, nz = cfg.grid_size
    k = cfg.max_neighbors_per_cell
    rng = np.random.default_rng(3)
    base = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"))
    pos = (base[:, None] + rng.uniform(size=(3, k, nx, ny, nz))) * cfg.cell_size
    pos = pos + np.asarray(cfg.grid_offset).reshape(3, 1, 1, 1, 1)
    mask = (rng.uniform(size=(k, nx, ny, nz)) < 0.4).astype(np.float64)
    data = np.concatenate([
        pos, mask[None], rng.standard_normal((3, k, nx, ny, nz)),
        rng.standard_normal((9, k, nx, ny, nz)) * 0.2,
    ]) * mask[None]
    data = data.astype(np.float32)
    jn, jd = transfers._p2g_slots_jnp(jnp.asarray(data), cfg)
    tn, td = t_kernels.p2g_faces(torch.from_numpy(data), convert.config_from_fields(**vars(cfg)))
    for a in range(3):
        want = transfers._normalize(jn[a], jd[a])
        got = t_transfers._normalize(tn[a], td[a])
        assert _normalized_err(got, want) < 2e-5
        np.testing.assert_allclose(td[a].numpy(), np.asarray(jd[a]), rtol=1e-5, atol=1e-6)


def _random_payload(cfg, rng, fill=0.4):
    """A slot payload (16, K, nx, ny, nz) whose slots are not prefix-dense:
    each slot occupied with probability `fill`, one cell full, a third of
    the grid (low z) empty, and the slot-0 particles exactly on their cell's
    corner, so on faces, tile borders and the domain's border."""
    nx, ny, nz = cfg.grid_size
    k = cfg.max_neighbors_per_cell
    base = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"))
    frac = rng.uniform(size=(3, k, nx, ny, nz))
    frac[:, 0] = 0.0
    pos = (base[:, None] + frac) * cfg.cell_size
    pos = pos + np.asarray(cfg.grid_offset).reshape(3, 1, 1, 1, 1)
    mask = (rng.uniform(size=(k, nx, ny, nz)) < fill).astype(np.float64)
    mask[..., : nz // 3] = 0.0
    mask[:, nx // 2, ny // 2, nz - 2] = 1.0
    data = np.concatenate([
        pos, mask[None], rng.standard_normal((3, k, nx, ny, nz)),
        rng.standard_normal((9, k, nx, ny, nz)) * 0.2,
    ]) * mask[None]
    return data.astype(np.float32)


def _p2g_tiles(data, cfg, tile, cap):
    """Kernel B's algorithm (``csrc/p2g.cu``) in numpy, float32 throughout:
    a block per tile of lattice points; 32 slots a cell at a time, the
    occupied slots of the tile's cells and one-cell halo compacted into one
    list in cell and slot order (a cell's list padded to an odd length), the
    list staged in chunks of
    whole cells of at most `cap` places, a thread per (j, l) column that
    feeds the tile's points along x from each slot it reads (x offsets
    -1, 0, +1) in the order plane, y offset, z offset, slot. Returns the
    unnormalized (num, den) face arrays and the most chunks a tile took."""
    f32 = np.float32
    nx, ny, nz = cfg.grid_size
    k_slots = data.shape[1]
    tx, ty, tz = tile
    hx, hy, hz = tx + 2, ty + 2, tz + 2
    h = f32(cfg.cell_size)
    ox, oy, oz = (f32(o) for o in cfg.grid_offset)
    affine = cfg.scheme == TransferScheme.APIC
    shapes = [(nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)]
    num = [np.zeros(sh, f32) for sh in shapes]
    den = [np.zeros(sh, f32) for sh in shapes]
    half = f32(0.5)

    def hat(t):
        return max(f32(1.0) - abs(t), f32(0.0))

    most_chunks = 0
    for t0x in range(0, nx + 1, tx):
        for t0y in range(0, ny + 1, ty):
            for t0z in range(0, nz + 1, tz):
                acc = np.zeros((ty, tz, tx, 6), f32)  # nu, du, nv, dv, nw, dw per point
                chunks = 0
                for w0 in range(0, k_slots, 32):  # the slots w0 ... w0 + 31, a word at a time
                    # occupancy of the word's slots of the tile's cells and halo, in
                    # (x, y, z) order
                    cells, occupied = [], []
                    for hc in range(hx * hy * hz):
                        c = (t0x - 1 + hc // (hy * hz), t0y - 1 + (hc // hz) % hy, t0z - 1 + hc % hz)
                        inside = all(0 <= c[a] < (nx, ny, nz)[a] for a in range(3))
                        cells.append(c)
                        word = range(w0, min(w0 + 32, k_slots))
                        occupied.append([k for k in word if data[(3, k) + c] != 0] if inside else [])
                    if not any(occupied):
                        continue
                    first = np.concatenate([[0], np.cumsum([(len(o) | 1) if o else 0 for o in occupied])])
                    c0 = 0
                    while c0 < len(cells):
                        base = first[c0]
                        c1 = max(c for c in range(c0 + 1, len(cells) + 1) if first[c] - base <= cap)
                        chunks += 1
                        pool = {}
                        for hc in range(c0, c1):
                            for nth, k in enumerate(occupied[hc]):
                                s = data[(slice(None), k) + cells[hc]]
                                g = ((s[0] - ox) / h, (s[1] - oy) / h, (s[2] - oz) / h)
                                a9 = s[7:16] if affine else np.zeros(9, f32)
                                pool[first[hc] - base + nth] = (g, s[0:3], s[3], s[4:7], a9)
                        for tj in range(ty):
                            for tl in range(tz):
                                fj, fl = f32(t0y + tj), f32(t0z + tl)
                                yj, zl = fj * h + oy, fl * h + oz
                                yc, zc = (fj + half) * h + oy, (fl + half) * h + oz
                                for p in range(hx):
                                    cx = f32(t0x - 1 + p)
                                    for n in range(9):
                                        dy, dz = n // 3 - 1, n % 3 - 1
                                        hc = (p * hy + tj + 1 + dy) * hz + tl + 1 + dz
                                        if not c0 <= hc < c1:
                                            continue
                                        for e in range(len(occupied[hc])):
                                            g, x, m, v, a9 = pool[first[hc] - base + e]
                                            hy0, hy5 = hat(g[1] - fj), hat(g[1] - half - fj)
                                            hz0, hz5 = hat(g[2] - fl), hat(g[2] - half - fl)
                                            wu, wv, ww = m * hy5 * hz5, m * hy0 * hz5, m * hy5 * hz0
                                            y0, y5, z0, z5 = yj - x[1], yc - x[1], zl - x[2], zc - x[2]
                                            su = v[0] + a9[1] * y5 + a9[2] * z5
                                            sv = v[1] + a9[4] * y0 + a9[5] * z5
                                            sw = v[2] + a9[7] * y5 + a9[8] * z0
                                            for r in range(3):  # x offset r - 1 of the cell from the point
                                                i = p - r
                                                if not 0 <= i < tx:
                                                    continue
                                                fi = cx + f32(1 - r)
                                                a = acc[tj, tl, i]
                                                if r != 2:
                                                    w = wu * hat(g[0] - fi)
                                                    a[0] += w * (su + a9[0] * (fi * h + ox - x[0]))
                                                    a[1] += w
                                                hx5 = hat(g[0] - half - fi)
                                                xc = (fi + half) * h + ox - x[0]
                                                if dy != 1:
                                                    w = wv * hx5
                                                    a[2] += w * (sv + a9[3] * xc)
                                                    a[3] += w
                                                if dz != 1:
                                                    w = ww * hx5
                                                    a[4] += w * (sw + a9[6] * xc)
                                                    a[5] += w
                        c0 = c1
                most_chunks = max(most_chunks, chunks)
                for tj in range(ty):
                    for tl in range(tz):
                        for i in range(tx):
                            pt = (t0x + i, t0y + tj, t0z + tl)
                            for axis in range(3):
                                if all(pt[a] < shapes[axis][a] for a in range(3)):
                                    num[axis][pt] = acc[tj, tl, i, 2 * axis]
                                    den[axis][pt] = acc[tj, tl, i, 2 * axis + 1]
    return num, den, most_chunks


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("k", [5, 12, 40])
def test_p2g_tile_algorithm_matches_jax_oracle(scheme, k):
    """The tile algorithm of kernel B against ``transfers._p2g_slots_jnp`` on
    a grid no tile divides, at up to 40 slots a cell (two words of the
    occupancy mask): slots that are not prefix-dense, a full cell,
    particles on tile and domain borders, a chunk size that cuts every busy
    tile's list several times; and the same bits whatever the tile's shape
    and the chunk size."""
    cfg = SimConfig(
        grid_size=(7, 5, 6), cell_size=0.7, grid_offset=(0.3, -0.2, 0.1),
        scheme=scheme, max_neighbors_per_cell=k,
    )
    data = _random_payload(cfg, np.random.default_rng(11 + k))
    jn, jd = transfers._p2g_slots_jnp(jnp.asarray(data), cfg)
    num, den, chunks = _p2g_tiles(data, cfg, (2, 3, 4), cap=2 * k + 1)
    assert chunks > 2
    for a in range(3):
        want = transfers._normalize(jn[a], jd[a])
        got = t_transfers._normalize(torch.from_numpy(num[a]), torch.from_numpy(den[a]))
        assert _normalized_err(got, want) < 2e-5
        np.testing.assert_allclose(den[a], np.asarray(jd[a]), rtol=1e-5, atol=1e-6)
    num2, den2, chunks2 = _p2g_tiles(data, cfg, (3, 2, 2), cap=1 << 20)
    assert chunks2 == -(-k // 32)  # one chunk a word of slots
    for a in range(3):
        np.testing.assert_array_equal(num[a], num2[a])
        np.testing.assert_array_equal(den[a], den2[a])


@pytest.mark.parametrize("case", ["dtype", "shape", "strides"])
def test_p2g_kernel_wrapper_refuses(case):
    """What kernel B's wrapper does not take raises before anything is
    launched: another dtype, a payload that does not fit the grid, a payload
    that is not contiguous. It takes any number of slots a cell."""
    cfg = convert.config_from_fields(**vars(SimConfig(grid_size=(3, 2, 2), max_neighbors_per_cell=4)))
    data = torch.zeros((16, 4, 3, 2, 2))
    bad, error = {
        "dtype": (data.double(), TypeError),
        "shape": (torch.zeros((16, 4, 3, 2, 3)), ValueError),
        "strides": (torch.zeros((16, 4, 3, 2, 4))[..., ::2], ValueError),
    }[case]
    with pytest.raises(error):
        t_kernels._p2g_faces_cuda(bad, cfg)


ALL_SCHEMES = [TransferScheme.APIC, TransferScheme.PIC, TransferScheme.FLIP]


def _overflowing(scheme, window):
    """Particles crammed into the two corner cells of an odd grid with an
    offset and a non-unit cell, far past K = 4 slots, the rest spread out;
    slotsort's slot grid and overflow window, with every third overflow row
    made inactive. `window` "past n": the default capacity, so the window
    (all n rows) reaches past the last row; "cut": 256 rows, fewer than the
    overflow rows."""
    cfg = SimConfig(
        grid_size=(7, 5, 6), cell_size=0.7, grid_offset=(0.3, -0.2, 0.1), scheme=scheme,
        max_neighbors_per_cell=4, particle_capacity=1024,
        p2g_overflow_capacity=4096 if window == "past n" else 256,
    )
    rng = np.random.default_rng(17)
    n = cfg.particle_capacity
    h, off = cfg.cell_size, np.asarray(cfg.grid_offset)
    top = np.asarray(cfg.grid_size) - 1
    # the low corner's particles lie below the transverse faces' first
    # layer, so some of their corners fall outside the face arrays
    pos = np.concatenate([
        rng.uniform(0.02, 0.45, (300, 3)), top + rng.uniform(0.55, 0.98, (300, 3)),
        rng.uniform(0.0, 1.0, (n - 600, 3)) * np.asarray(cfg.grid_size),
    ]) * h + off
    state = new_state(cfg, jax.random.PRNGKey(3))._replace(
        position=jnp.asarray(pos.astype(np.float32)),
        velocity=jnp.asarray(rng.standard_normal((n, 3)).astype(np.float32)),
        affine=jnp.asarray((rng.standard_normal((n, 3, 3)) * 0.2).astype(np.float32)),
        active=jnp.ones((n,), bool),
    )
    sb = slotsort.sort_and_build(state, cfg)
    st = sb.state
    overflow = np.asarray(sb.slot_grid.overflow)
    active = np.asarray(st.active).copy()
    active[np.flatnonzero(overflow)[::3]] = False
    return cfg, sb, st, active


def _p2g_overflow_model(num, den, start, overflow, active, pos, vel, aff, cfg, cap, rng):
    """Kernels p2g_overflow and p2g_normalize (``csrc/p2g_overflow.cu``) in
    numpy, float32 throughout, on kernel B's sums: one contribution per
    (window row, axis, corner), the threads taken in a random order (the
    kernel adds with atomics); a row past n, not overflow or not active, and
    a corner outside its face array add nothing. Returns (u, v, w) and the
    count of in-window rows' corners that fell outside."""
    f32 = np.float32
    n = pos.shape[0]
    h, o = f32(cfg.cell_size), np.asarray(cfg.grid_offset, f32)
    num = [a.copy() for a in num]
    den = [a.copy() for a in den]
    t = rng.permutation(24 * cap)
    corner, axis, row = t % 8, (t // 8) % 3, start + t // 24
    live = row < n
    row = np.minimum(row, n - 1)
    live &= overflow[row] & active[row]
    outside = 0
    for a, shape in enumerate(t_kernels.face_shapes(cfg)):
        sel = live & (axis == a)
        r, c = row[sel], corner[sel]
        inb = np.ones(r.shape, bool)
        idx, wd, d = [], [], []
        for k in range(3):
            shift = f32(0.0 if k == a else 0.5)
            x = pos[r, k]
            g = (x - o[k]) / h - shift
            base = np.floor(g)
            frac = g - base
            bit = (c >> (2 - k)) & 1
            i = base.astype(np.int64) + bit
            inb &= (i >= 0) & (i < shape[k])
            idx.append(i)
            wd.append(np.where(bit == 1, frac, f32(1.0) - frac))
            d.append(((o[k] + shift * h) + i.astype(f32) * h) - x)
        w = wd[0] * wd[1] * wd[2]
        val = vel[r, a]
        if cfg.scheme == t_transfers.TransferScheme.APIC:  # the port's enum
            val = val + (aff[r, a, 0] * d[0] + aff[r, a, 1] * d[1] + aff[r, a, 2] * d[2])
        flat = (idx[0] * shape[1] + idx[1]) * shape[2] + idx[2]
        np.add.at(num[a].reshape(-1), flat[inb], (w * val)[inb])
        np.add.at(den[a].reshape(-1), flat[inb], w[inb])
        outside += int(np.sum(~inb))
    eps = f32(1e-6)
    out = [np.where(dn > eps, nm / np.maximum(dn, eps), f32(0.0)) for nm, dn in zip(num, den)]
    return out, outside


@pytest.mark.parametrize("window", ["past n", "cut"])
@pytest.mark.parametrize("scheme", ALL_SCHEMES)
def test_p2g_overflow_algorithm_matches_jax(scheme, window):
    """The algorithm of kernels p2g_overflow and p2g_normalize, on top of
    kernel B's plain sums, against the JAX package's ``p2g_slots`` with
    ``overflow_start``: a window reaching past the last row or cut short of
    the overflow rows, inactive overflow rows, corners outside the face
    arrays."""
    cfg, sb, st, active = _overflowing(scheme, window)
    tcfg = convert.config_from_fields(**vars(cfg))
    n = st.position.shape[0]
    start = int(sb.n_kept)
    overflow = np.asarray(sb.slot_grid.overflow)
    cap = t_transfers.overflow_window(tcfg, n)
    n_over = int(overflow.sum())
    assert (start + cap > n) == (window == "past n") and n_over > 256
    assert not active[overflow].all() and active[overflow].any()
    want = transfers.p2g_slots(
        sb.slot_grid, st.position, st.velocity, st.affine, jnp.asarray(active), cfg,
        overflow_start=sb.n_kept,
    )
    num, den = t_kernels.p2g_faces(_t(sb.slot_grid.data), tcfg)
    got, outside = _p2g_overflow_model(
        [a.numpy() for a in num], [a.numpy() for a in den], start, overflow, active,
        np.asarray(st.position), np.asarray(st.velocity), np.asarray(st.affine), tcfg, cap,
        np.random.default_rng(5),
    )
    assert outside > 0
    for g, w in zip(got, want):
        assert _normalized_err(g, w) < 2e-5


def _overflow_args(cfg, n=6, cap=256):
    """Well-formed CPU arguments of ``kernels._p2g_overflow_cuda``."""
    num = [torch.zeros(s) for s in t_kernels.face_shapes(cfg)]
    den = [torch.zeros(s) for s in t_kernels.face_shapes(cfg)]
    return dict(
        num=num, den=den, position=torch.zeros((n, 3)), velocity=torch.zeros((n, 3)),
        affine=torch.zeros((n, 3, 3)), active=torch.ones(n, dtype=torch.bool),
        overflow=torch.ones(n, dtype=torch.bool), start=torch.zeros((), dtype=torch.int32),
        rows=None,
    )


@pytest.mark.parametrize("case", [
    "num dtype", "den shape", "num strides", "position shape", "velocity dtype",
    "affine shape", "active dtype", "overflow shape", "start dtype", "rows shape",
    "start and rows", "neither",
])
def test_p2g_overflow_wrapper_refuses(case):
    """What the wrapper of p2g_overflow and p2g_normalize does not take
    raises before anything is launched: another dtype, a shape that does not
    fit the grid or the particles, a face array that is not contiguous, both
    or neither of the window's start and rows."""
    cfg = convert.config_from_fields(**vars(SimConfig(grid_size=(3, 2, 2), scheme=TransferScheme.APIC)))
    args = _overflow_args(cfg)
    fixes = {
        "num dtype": ("num", [args["num"][0].double(), *args["num"][1:]], TypeError),
        "den shape": ("den", [*args["den"][:2], torch.zeros((3, 2, 2))], ValueError),
        "num strides": ("num", [args["num"][0], torch.zeros((3, 3, 4))[..., ::2], args["num"][2]],
                        ValueError),
        "position shape": ("position", torch.zeros((6, 4)), ValueError),
        "velocity dtype": ("velocity", torch.zeros((6, 3), dtype=torch.float64), TypeError),
        "affine shape": ("affine", torch.zeros((6, 3)), ValueError),
        "active dtype": ("active", torch.ones(6), TypeError),
        "overflow shape": ("overflow", torch.ones(5, dtype=torch.bool), ValueError),
        "start dtype": ("start", torch.zeros((), dtype=torch.int64), TypeError),
        "rows shape": ("rows", torch.zeros(5, dtype=torch.int32), ValueError),
        "start and rows": ("rows", torch.zeros(6, dtype=torch.int32), ValueError),
        "neither": ("start", None, ValueError),
    }
    key, value, error = fixes[case]
    args[key] = value
    if case == "rows shape":
        args["start"] = None
    with pytest.raises(error):
        t_kernels._p2g_overflow_cuda(
            args["num"], args["den"], args["position"], args["velocity"], args["affine"],
            args["active"], args["overflow"], args["start"], args["rows"], cfg,
        )


def test_p2g_overflow_refuses_cpu_tensors():
    """The kernels' wrapper takes CUDA tensors only: ``p2g_slots`` keeps
    CPU tensors on the plain path."""
    cfg = convert.config_from_fields(**vars(SimConfig(grid_size=(3, 2, 2))))
    a = _overflow_args(cfg)
    with pytest.raises(ValueError):
        t_kernels.p2g_overflow(a["num"], a["den"], a["position"], a["velocity"], a["affine"],
                               a["active"], a["overflow"], cfg, start=a["start"])


@pytest.mark.parametrize("overflow_start", [True, False])
def test_p2g_slots_counts_the_plain_merge_on_the_cpu(overflow_start):
    """On CPU tensors ``p2g_slots`` merges the overflow rows on the plain
    path: it counts ``p2g_overflow.plain`` once a call and never
    ``p2g_overflow.kernel``, and launches nothing."""
    from libfluid_tpu_torch import profiling

    cfg, tcfg, state = _crammed(TransferScheme.APIC)
    s = jax.tree_util.tree_map(np.asarray, state)
    tstate = convert.state_from_numpy(
        dict(position=s.position, velocity=s.velocity, affine=s.affine,
             active=s.active, u=s.grid.u, v=s.grid.v, w=s.grid.w,
             cell_type=s.grid.cell_type, solid=s.solid, pressure=s.pressure,
             time=s.time),
        tcfg, "cpu",
    )
    tsb = t_slotsort.sort_and_build(tstate, tcfg)
    ts = tsb.state
    t_kernels.reset_launches()
    profiling.clear()
    with profiling.tracing(), profiling.span("p2g"):
        for _ in range(2):
            t_transfers.p2g_slots(
                tsb.slot_grid, ts.position, ts.velocity, ts.affine, ts.active, tcfg,
                overflow_start=tsb.n_kept if overflow_start else None,
            )
    (frame,) = profiling.frames()
    profiling.clear()
    assert frame.total("p2g_overflow.plain") == 2
    assert frame.total("p2g_overflow.kernel") == 0
    assert frame.total("reads.p2g.nonzero") == (0 if overflow_start else 2)
    assert not any(t_kernels.LAUNCHES.values())


def _fake_kernels(num, den, position, velocity, affine, active, overflow, start, rows, cfg):
    """What ``kernels._p2g_overflow_cuda`` does, in plain PyTorch on the CPU:
    the window's rows added to kernel B's sums in place, then normalised."""
    n = position.shape[0]
    idx = t_transfers._overflow_rows(overflow, n, cfg, start, rows)
    ok = idx < n
    safe = torch.clamp(idx, max=n - 1).long()
    use_affine = cfg.scheme == t_transfers.TransferScheme.APIC  # the port's enum
    for axis in range(3):
        n_o, d_o = t_transfers._p2g_axis(
            position[safe], velocity[safe][:, axis],
            affine[safe][:, axis, :] if use_affine else None, ok & active[safe], cfg, axis,
        )
        num[axis].add_(n_o)
        den[axis].add_(d_o)
    return tuple(t_transfers._normalize(num[a], den[a]) for a in range(3))


@pytest.mark.parametrize("scheme", ALL_SCHEMES)
def test_p2g_overflow_function_gradients(scheme, monkeypatch):
    """The autograd Function around the two kernels, with the kernels' work
    done in place by plain PyTorch on the CPU: its forward equals the plain
    merge; with inputs that want a gradient it leaves kernel B's sums as they
    were and its backward gives the plain merge's gradients of the sums,
    positions, velocities and affine matrices; with none, it adds to B's
    sums in place."""
    monkeypatch.setattr(t_kernels, "_p2g_overflow_cuda", _fake_kernels)
    cfg, sb, st, active = _overflowing(scheme, "cut")
    tcfg = convert.config_from_fields(**vars(cfg))
    num, den = t_kernels.p2g_faces(_t(sb.slot_grid.data), tcfg)
    pos, vel, aff = _t(st.position), _t(st.velocity), _t(st.affine)
    act, over, start = _t(active), _t(sb.slot_grid.overflow), _t(sb.n_kept)
    idx = t_transfers._overflow_rows(over, pos.shape[0], tcfg, start)
    rng = np.random.default_rng(9)
    weights = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in t_kernels.face_shapes(tcfg)]

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (*num, *den, pos, vel, aff)]
        out = fn(leaves)
        loss = sum(torch.sum(o * w) for o, w in zip(out, weights))
        return out, leaves, torch.autograd.grad(loss, leaves, allow_unused=True)

    want_out, _, want = grads(lambda l: t_transfers._merge_overflow(
        l[:3], l[3:6], l[6], l[7], l[8], act, idx, tcfg))
    got_out, leaves, got = grads(lambda l: t_kernels._P2GOverflow.apply(
        *l, act, over, start, None, tcfg))
    for a in range(3):
        torch.testing.assert_close(got_out[a], want_out[a], rtol=0, atol=0)
    for leaf, g, w in zip(leaves, got, want):
        if w is None:
            assert g is None or not torch.any(g)
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert all(torch.equal(l, t) for l, t in zip(leaves[:6], (*num, *den)))

    sums = [t.clone() for t in (*num, *den)]
    with torch.no_grad():
        plain = t_kernels._P2GOverflow.apply(*sums, pos, vel, aff, act, over, start, None, tcfg)
    for a in range(3):
        torch.testing.assert_close(plain[a], want_out[a], rtol=0, atol=0)
    assert not torch.equal(sums[0], num[0])  # B's sums took the overflow rows in place


def _p2g_bwd_model(data, gnum, gden, cfg, tile):
    """Kernel B''s second launch (``csrc/p2g_bwd.cu``) in numpy, float32
    throughout, on zeros as its first launch leaves them: a block per tile of
    cells; a tile without a particle skipped; the (gn, gd) pairs of the
    faces the tile's cells reach in one box per face axis (cells + 1 along
    the axis, cells + 2 across it), faces outside an array as zeros; per
    occupied slot and dimension the hat, its derivative with the JAX
    package's subgradients and the lever x_face - x at the aligned offsets
    0, 1 and the half-shifted offsets -1, 0, 1; then the faces out of the
    box, axis, x, y, z offsets ascending: a window of two half-shifted
    offsets a dimension, dropping the end whose hat and derivative are both
    0 (24 faces), or all 54 where some dimension has both ends live (a
    particle on a kink)."""
    f32 = np.float32
    nx, ny, nz = cfg.grid_size
    k_slots = data.shape[1]
    h = f32(cfg.cell_size)
    o = [f32(v) for v in cfg.grid_offset]
    affine = cfg.scheme == TransferScheme.APIC
    face_dims = [(nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)]
    out = np.zeros_like(data)
    half, one, zero = f32(0.5), f32(1.0), f32(0.0)
    widest = 0

    def hat(t):
        return max(one - abs(t), zero)

    def dhat(t):
        y = one - abs(t)
        gate = one if y > 0 else (half if y == 0 else zero)
        return -gate if t >= 0 else gate

    for t0 in np.ndindex(*(-(-n // t) for n, t in zip((nx, ny, nz), tile))):
        t0 = [a * b for a, b in zip(t0, tile)]
        cells = [c for c in np.ndindex(*tile)
                 if all(t0[q] + c[q] < (nx, ny, nz)[q] for q in range(3))]
        if not any(data[(3, slice(None)) + tuple(t0[q] + c[q] for q in range(3))].any() for c in cells):
            continue
        boxes = []
        for a in range(3):
            dims = [tile[q] + (1 if q == a else 2) for q in range(3)]
            box = np.zeros(dims + [2], f32)
            for e in np.ndindex(*dims):
                f = tuple(t0[q] + e[q] - (0 if q == a else 1) for q in range(3))
                if all(0 <= f[q] < face_dims[a][q] for q in range(3)):
                    box[e] = (gnum[a][f], gden[a][f])
            boxes.append(box)
        for k in range(k_slots):
            for ic in cells:
                c = tuple(t0[q] + ic[q] for q in range(3))
                s = data[(slice(None), k) + c]
                m = s[3]
                if m == 0:
                    continue
                p = s[0:3]
                tb = np.zeros((3, 3, 2, 3), f32)  # (hat, dhat, lever)[q][kind][i]
                for q in range(3):
                    gp = (p[q] - o[q]) / h
                    for i in range(3):
                        fa, fs = f32(c[q] + i), f32(c[q] + i - 1)
                        ta, ts = gp - fa, (gp - half) - fs
                        tb[0, q, 0, i], tb[1, q, 0, i] = hat(ta), dhat(ta)
                        tb[2, q, 0, i] = (fa * h + o[q]) - p[q]
                        tb[0, q, 1, i], tb[1, q, 1, i] = hat(ts), dhat(ts)
                        tb[2, q, 1, i] = ((fs + half) * h + o[q]) - p[q]
                d_m, d_t, d_x = zero, [zero] * 3, [zero] * 3
                d_v, d_a = [zero] * 3, [zero] * 9
                dead_lo = [tb[0, q, 1, 0] == 0 and tb[1, q, 1, 0] == 0 for q in range(3)]
                dead_hi = [tb[0, q, 1, 2] == 0 and tb[1, q, 1, 2] == 0 for q in range(3)]
                wide = any(not lo and not hi for lo, hi in zip(dead_lo, dead_hi))
                across = [range(3) if wide else range(int(lo), int(lo) + 2) for lo in dead_lo]
                widest = max(widest, 3 if wide else 2)
                for a in range(3):
                    va = s[4 + a]
                    arow = s[7 + 3 * a: 10 + 3 * a] if affine else np.zeros(3, f32)
                    kind = [0 if q == a else 1 for q in range(3)]
                    for i in itertools.product(*(range(2) if q == a else across[q] for q in range(3))):
                        gn, gd = boxes[a][tuple(ic[q] + i[q] for q in range(3))]
                        hq = [tb[0, q, kind[q], i[q]] for q in range(3)]
                        dq = [tb[1, q, kind[q], i[q]] for q in range(3)]
                        lever = [tb[2, q, kind[q], i[q]] for q in range(3)]
                        big_h = hq[0] * hq[1] * hq[2]
                        val = va
                        if affine:
                            for q in range(3):
                                val = val + arow[q] * lever[q]
                        gw = gn * val + gd
                        d_m = d_m + gw * big_h
                        gwm = gw * m
                        d_t[0] = d_t[0] + gwm * dq[0] * hq[1] * hq[2]
                        d_t[1] = d_t[1] + gwm * hq[0] * dq[1] * hq[2]
                        d_t[2] = d_t[2] + gwm * hq[0] * hq[1] * dq[2]
                        gnw = gn * m * big_h
                        d_v[a] = d_v[a] + gnw
                        if affine:
                            for q in range(3):
                                d_a[3 * a + q] = d_a[3 * a + q] + gnw * lever[q]
                                d_x[q] = d_x[q] - gnw * arow[q]
                res = [d_t[q] / h + d_x[q] for q in range(3)] + [d_m] + d_v + d_a
                out[(slice(None), k) + c] = res
    return out, widest


@pytest.mark.parametrize("scheme", SCHEMES)
def test_p2g_bwd_kernel_model_matches_jax(scheme):
    """The tile-and-table arithmetic of kernel B' against ``jax.vjp`` of
    ``transfers._p2g_slots_jnp`` on a grid no tile divides: slots that are
    not prefix-dense, a third of the grid empty, slot-0 particles exactly on
    cell corners (t = 0 at the aligned faces, |t| = 1 at their neighbours:
    the hat's kinks). Occupied slots within 1e-5 of the largest component
    (as the kernel is held to its plain autograd on the card), empty slots 0,
    and the same bits whatever the tile's shape."""
    cfg = SimConfig(
        grid_size=(7, 5, 6), cell_size=0.7, grid_offset=(0.3, -0.2, 0.1),
        scheme=scheme, max_neighbors_per_cell=5,
    )
    rng = np.random.default_rng(23)
    data = _random_payload(cfg, rng)
    nx, ny, nz = cfg.grid_size
    faces = [(nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)]
    gnum = [rng.standard_normal(sh).astype(np.float32) for sh in faces]
    gden = [rng.standard_normal(sh).astype(np.float32) for sh in faces]
    # one particle at the centre of its cell along x, where both ends of its
    # half-shifted offsets are live (|t| = 1); every other slot takes windows
    # of two. The nearest float32 whose cell coordinate is 3.5 exactly:
    f32 = np.float32
    x = f32(cfg.grid_offset[0]) + f32(4.5) * f32(cfg.cell_size)
    near = [x]
    for _ in range(4):
        near = [np.nextafter(near[0], f32(-np.inf)), *near, np.nextafter(near[-1], f32(np.inf))]
    centre = [v for v in near if (v - f32(cfg.grid_offset[0])) / f32(cfg.cell_size) == f32(4.5)]
    assert centre
    data[:, 0, 4, 2, nz - 2] = data[:, 0, nx // 2, ny // 2, nz - 2]  # an occupied slot's payload
    data[0:3, 0, 4, 2, nz - 2] = (centre[0], cfg.grid_offset[1] + 2.3 * cfg.cell_size,
                                  cfg.grid_offset[2] + (nz - 1.6) * cfg.cell_size)
    _, vjp = jax.vjp(lambda d: transfers._p2g_slots_jnp(d, cfg), jnp.asarray(data))
    (want,) = vjp((tuple(jnp.asarray(g) for g in gnum), tuple(jnp.asarray(g) for g in gden)))
    want = np.asarray(want)
    got, widest = _p2g_bwd_model(data, gnum, gden, cfg, (2, 2, 4))
    assert widest == 3
    occ = data[3] != 0
    assert not got[:, ~occ].any()
    err = np.max(np.abs(got - want)[:, occ]) / np.max(np.abs(want[:, occ]))
    assert err < 1e-5, err
    if scheme == TransferScheme.PIC:
        assert not got[7:].any()
    np.testing.assert_array_equal(got, _p2g_bwd_model(data, gnum, gden, cfg, (3, 4, 3))[0])


def test_g2p_pic_matches_jax():
    """Kernel D's plain version against JAX's g2p_pic on random faces, with
    particles inside, on faces, and just outside the domain (clamped cell)."""
    cfg = SimConfig(grid_size=(9, 6, 7), cell_size=0.7, grid_offset=(0.3, -0.2, 0.1))
    tcfg = convert.config_from_fields(**vars(cfg))
    rng = np.random.default_rng(7)
    g = grids.zeros(cfg)
    u, v, w = (rng.standard_normal(a.shape).astype(np.float32) for a in (g.u, g.v, g.w))
    off, h = np.asarray(cfg.grid_offset), cfg.cell_size
    lo, hi = off - 0.4 * h, off + np.asarray(cfg.grid_size) * h + 0.4 * h
    pos = rng.uniform(lo, hi, size=(3000, 3))
    pos[:64] = off + rng.integers(0, 6, size=(64, 3)) * h  # exactly on faces
    pos = pos.astype(np.float32)
    want_v, want_a = transfers.g2p_pic(
        g._replace(u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w)), jnp.asarray(pos), cfg
    )
    tg = t_grids.zeros(tcfg, "cpu")._replace(u=_t(u), v=_t(v), w=_t(w))
    got_v, got_a = t_transfers.g2p_pic(tg, _t(pos), tcfg)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-5, atol=1e-5)


def _g2p_model(uvw, pos, cfg, gvel=None, gaff=None, block=16, box=9 * 6 * 9):
    """Kernels D and D' (``csrc/g2p.cu``, ``csrc/g2p_bwd.cu``) in numpy,
    float32 throughout, a particle at a time in the kernels' order: per axis
    one table of hat, derivative and subgradient factors for the face array
    staggered along it (offsets 0, 1 from the clamped cell) and one for the
    other two arrays (the window of two live half-shifted offsets, or all
    three where a distance rounds onto an end of the support; an entry
    outside the array gets weight 0 and a clamped index), the sums factored
    along z, then y, then x, and 1/h applied once. Returns (vel, aff), and
    with cotangents also (gu, gv, gw, gpos). Kernel D' takes `block`
    particles a block: those in the x plane of the block's first particle
    add their face cotangents into the block's box (the faces around the
    (y, z) range of their cells, three x layers of each array) if that has
    at most `box` entries, and the box's nonzero entries are added to the
    face arrays at the block's end; the others add straight into the face
    arrays. Also returns counts: particles that took windows of three, and
    that went through a box."""
    f32 = np.float32
    dims = cfg.grid_size
    h = f32(cfg.cell_size)
    rh = f32(1.0) / h
    origin = [f32(o) for o in cfg.grid_offset]
    backward = gvel is not None

    def hat(d):
        return max(f32(1.0) - abs(d), f32(0.0))

    def sfac(d):
        return f32(0.0) if not (d >= -1.0 and d < 1.0) else (f32(-1.0) if d > 0 else f32(1.0))

    def dhat(d):
        y = f32(1.0) - abs(d)
        gate = f32(1.0) if y > 0 else (f32(0.5) if y == 0 else f32(0.0))
        return -gate if d >= 0 else gate

    def axis_of(x, q):
        g = (f32(x) - origin[q]) / h
        c = min(max(int(np.floor(g)), 0), dims[q] - 1)
        gh = g - f32(0.5)
        low = gh - f32(c) < 0
        triple = low and c + 1 < dims[q] and gh - f32(c + 1) == f32(-1.0)
        if backward and not low:
            triple = c > 0 and gh - f32(c - 1) == f32(1.0)
        return g, gh, c, low, triple

    def tab_of(ax, q, w):
        g, gh, c, low, _ = ax
        rows = []
        for o in range(2):
            d = g - f32(c + o)
            rows.append((hat(d), sfac(d), dhat(d), c + o))
        first = c + (-1 if (w == 3 or low) else 0)
        for o in range(w):
            i = first + o
            d = gh - f32(i)
            inside = 0 <= i < dims[q]
            zero = f32(0.0)
            rows.append((hat(d) if inside else zero, sfac(d) if inside else zero,
                         dhat(d) if inside else zero, min(max(i, 0), dims[q] - 1)))
        return rows

    n = pos.shape[0]
    vel, aff = np.zeros((n, 3), f32), np.zeros((n, 3, 3), f32)
    gfaces = [np.zeros_like(a) for a in uvw]
    gpos = np.zeros((n, 3), f32)
    counts = {"triples": 0, "boxed": 0}
    for p in range(n):
        axes = [axis_of(pos[p, q], q) for q in range(3)]
        w = 3 if any(ax[4] for ax in axes) else 2
        counts["triples"] += w == 3
        if backward and p % block == 0:  # a new block: its box
            mates = [[axis_of(pos[m, q], q)[2] for q in range(3)] for m in range(p, min(p + block, n))]
            x0 = mates[0][0]
            ys, zs = ([c[q] for c in mates if c[0] == x0] for q in (1, 2))
            by0, bz0 = min(ys) - 1, min(zs) - 1
            ey, ez = max(ys) - by0 + 2, max(zs) - bz0 + 2
            boxes = [np.zeros((3, ey, ez), f32) for _ in range(3)] if 9 * ey * ez <= box else None
        boxed = backward and boxes is not None and axes[0][2] == x0
        counts["boxed"] += boxed
        tx, ty, tz = (tab_of(axes[q], q, w) for q in range(3))
        gd = [f32(0.0)] * 3
        for a in range(3):
            arr = uvw[a]
            ri, rj, rk = (range(0, 2) if q == a else range(2, 2 + w) for q in range(3))
            val = g0 = g1 = g2 = f32(0.0)
            if backward:
                cv, ca0, ca1, ca2 = gvel[p, a], gaff[p, a, 0] * rh, gaff[p, a, 1] * rh, gaff[p, a, 2] * rh
            for i in ri:
                c1 = c2 = c3 = f32(0.0)
                if backward:
                    pp, qq, rr = cv * tx[i][0] + ca0 * tx[i][1], ca1 * tx[i][0], ca2 * tx[i][0]
                for j in rj:
                    sn = ss = se = f32(0.0)
                    if backward:
                        tt, uu = ty[j][0] * pp + ty[j][1] * qq, ty[j][0] * rr
                    for k in rk:
                        at = (tx[i][3], ty[j][3], tz[k][3])
                        sample = arr[at]
                        sn += tz[k][0] * sample
                        ss += tz[k][1] * sample
                        se += tz[k][2] * sample
                        if backward:
                            gs = tz[k][0] * tt + tz[k][1] * uu
                            if gs != 0 and boxed:
                                boxes[a][at[0] - (x0 - 1), at[1] - by0, at[2] - bz0] += gs
                            elif gs != 0:
                                gfaces[a][at] += gs
                    c1 += ty[j][0] * sn
                    c2 += ty[j][1] * sn
                    c3 += ty[j][0] * ss
                    if backward:
                        gd[0] += tx[i][2] * (ty[j][0] * (cv * sn + ca2 * ss) + ty[j][1] * (ca1 * sn))
                        gd[1] += ty[j][2] * (pp * sn + rr * ss)
                        gd[2] += se * tt
                val += tx[i][0] * c1
                g0 += tx[i][1] * c1
                g1 += tx[i][0] * c2
                g2 += tx[i][0] * c3
            vel[p, a] = val
            aff[p, a] = (g0 * rh, g1 * rh, g2 * rh)
        gpos[p] = [g * rh for g in gd]
        if backward and boxes is not None and (p + 1 == n or (p + 1) % block == 0):
            for a in range(3):
                for at in zip(*np.nonzero(boxes[a])):
                    gfaces[a][x0 - 1 + at[0], by0 + at[1], bz0 + at[2]] += boxes[a][at]
    return (vel, aff), (*gfaces, gpos), counts


def g2p_case(case, n=240):
    """Faces and particles of one case of the G2P kernel models' tests, from
    numpy seeds: the configuration, the face arrays and the positions."""
    order, where = case.split("-")
    if where == "kinks":  # h = 1, offset 0: faces, cell centres and their neighbours are exact
        cfg = SimConfig(grid_size=(6, 5, 7))
    else:
        cfg = SimConfig(grid_size=(6, 5, 7), cell_size=0.7, grid_offset=(0.3, -0.2, 0.1))
    rng = np.random.default_rng(17)
    dims, h, off = np.asarray(cfg.grid_size), cfg.cell_size, np.asarray(cfg.grid_offset)
    g = grids.zeros(cfg)
    uvw = [rng.standard_normal(a.shape).astype(np.float32) for a in (g.u, g.v, g.w)]
    if where == "inside":
        cells = rng.uniform(0.0, 1.0, (n, 3)) * dims
    elif where == "outside":  # up to 0.4 cells beyond the domain on every side
        cells = rng.uniform(-0.4, 1.0, (n, 3)) * (dims + 0.4)
        cells[: n // 2] = rng.choice([-0.3, 0.2], (n // 2, 3)) + rng.integers(0, 2, (n // 2, 3)) * dims
    else:  # on faces and cell centres, the domain's faces included
        cells = rng.integers(0, dims + 1, (n, 3)) + rng.choice([0.0, 0.5, -0.5, 0.25], (n, 3))
        # just below the centre of cell 0 the distance to the next face but
        # one rounds to exactly -1: the hat is 0 there, the derivative factor 1
        cells[:12, rng.integers(0, 3, 12)] = np.float32(0.5) - np.float32(2.0 ** -25)
    pos = (off + cells * h).astype(np.float32)
    key = np.floor(np.clip((pos - off) / h, 0, dims - 1)).astype(int)
    pos = pos[np.lexsort((key[:, 2], key[:, 1], key[:, 0]))] if order == "sorted" else pos
    return cfg, uvw, pos


G2P_CASES = ["sorted-inside", "shuffled-inside", "sorted-outside", "shuffled-outside",
             "sorted-kinks", "shuffled-kinks"]


@pytest.mark.parametrize("case", G2P_CASES)
def test_g2p_kernel_model_matches_jax(case):
    """Kernel D's arithmetic (factor tables per axis, windows of two live
    offsets, 1/h once) against the JAX package's g2p_pic, for particles in
    cell order and shuffled, inside and outside the domain, and on the
    hats' kinks, where some take the windows of three."""
    cfg, uvw, pos = g2p_case(case)
    g = grids.zeros(cfg)._replace(u=jnp.asarray(uvw[0]), v=jnp.asarray(uvw[1]), w=jnp.asarray(uvw[2]))
    want_v, want_a = transfers.g2p_pic(g, jnp.asarray(pos), cfg)
    (vel, aff), _, counts = _g2p_model(uvw, pos, cfg)
    triples = counts["triples"]
    np.testing.assert_allclose(vel, np.asarray(want_v), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aff, np.asarray(want_a), rtol=1e-5, atol=1e-5)
    assert np.abs(np.asarray(want_a)).max() > 0.1
    # the port's plain version is held to the same
    tcfg = convert.config_from_fields(**vars(cfg))
    tg = t_grids.zeros(tcfg, "cpu")._replace(u=_t(uvw[0]), v=_t(uvw[1]), w=_t(uvw[2]))
    got_v, got_a = t_transfers.g2p_pic(tg, _t(pos), tcfg)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-5, atol=1e-5)
    assert triples > 0 if case.endswith("kinks") else triples == 0


@pytest.mark.parametrize("which", ["forward", "backward"])
@pytest.mark.parametrize("case", ["u dtype", "v shape", "w strides", "position shape",
                                  "position dtype", "position strides", "too many faces"])
def test_g2p_kernel_wrappers_refuse(case, which):
    """What the wrappers of kernels D and D' do not take raises before
    anything is launched: another dtype, faces that do not fit the grid,
    tensors that are not contiguous, a face array of 2^31 elements."""
    cfg = convert.config_from_fields(**vars(SimConfig(grid_size=(3, 2, 2))))
    u, v, w = (torch.zeros(s) for s in t_kernels.face_shapes(cfg))
    pos = torch.zeros((5, 3))
    args, error = {
        "u dtype": ((u.double(), v, w, pos), TypeError),
        "v shape": ((u, torch.zeros((3, 2, 2)), w, pos), ValueError),
        "w strides": ((u, v, torch.zeros((3, 2, 6))[..., ::2], pos), ValueError),
        "position shape": ((u, v, w, torch.zeros((5, 4))), ValueError),
        "position dtype": ((u, v, w, pos.double()), TypeError),
        "position strides": ((u, v, w, torch.zeros((5, 6))[:, ::2]), ValueError),
        "too many faces": ((u, v, w, pos), ValueError),
    }[case]
    if case == "too many faces":
        cfg = convert.config_from_fields(**vars(SimConfig(grid_size=(2048, 1024, 1024))))
    with pytest.raises(error):
        if which == "forward":
            t_transfers._g2p_cuda(*args, cfg)
        else:
            t_transfers.g2p_bwd(*args, torch.zeros((5, 3)), torch.zeros((5, 3, 3)), cfg)


@pytest.mark.parametrize("case", ["velocity cotangent shape", "affine cotangent dtype"])
def test_g2p_bwd_wrapper_refuses_cotangents(case):
    cfg = convert.config_from_fields(**vars(SimConfig(grid_size=(3, 2, 2))))
    u, v, w = (torch.zeros(s) for s in t_kernels.face_shapes(cfg))
    pos, gv, ga = torch.zeros((5, 3)), torch.zeros((5, 3)), torch.zeros((5, 3, 3))
    if case == "velocity cotangent shape":
        gv, error = torch.zeros((4, 3)), ValueError
    else:
        ga, error = ga.double(), TypeError
    with pytest.raises(error):
        t_transfers.g2p_bwd(u, v, w, pos, gv, ga, cfg)
