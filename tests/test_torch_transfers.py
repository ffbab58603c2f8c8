"""Parity of the PyTorch port's P2G (kernel B's plain version, a numpy
model of its tile algorithm, and the overflow scatter) and G2P (kernel D's
plain version) with the JAX package.

Tolerances are those of the JAX package's own Pallas-vs-oracle tests: P2G
faces within 2e-5 of the largest face value after normalization, G2P within
rtol/atol 1e-5."""

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
    a block per tile of lattice points, the occupied slots of the tile's
    cells and one-cell halo compacted into one list in cell and slot order
    (a cell's list padded to an odd length), the list staged in chunks of
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
                # occupancy of the tile's cells and halo, in (x, y, z) order
                cells, occupied = [], []
                for hc in range(hx * hy * hz):
                    c = (t0x - 1 + hc // (hy * hz), t0y - 1 + (hc // hz) % hy, t0z - 1 + hc % hz)
                    inside = all(0 <= c[a] < (nx, ny, nz)[a] for a in range(3))
                    cells.append(c)
                    occupied.append([k for k in range(k_slots) if data[(3, k) + c] != 0] if inside else [])
                if not any(occupied):
                    continue
                first = np.concatenate([[0], np.cumsum([(len(o) | 1) if o else 0 for o in occupied])])
                acc = np.zeros((ty, tz, tx, 6), f32)  # nu, du, nv, dv, nw, dw per point
                c0, chunks = 0, 0
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
@pytest.mark.parametrize("k", [5, 12])
def test_p2g_tile_algorithm_matches_jax_oracle(scheme, k):
    """The tile algorithm of kernel B against ``transfers._p2g_slots_jnp`` on
    a grid no tile divides: slots that are not prefix-dense, a full cell,
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
    assert chunks2 == 1
    for a in range(3):
        np.testing.assert_array_equal(num[a], num2[a])
        np.testing.assert_array_equal(den[a], den2[a])


@pytest.mark.parametrize("case", ["too many slots", "dtype", "shape", "strides"])
def test_p2g_kernel_wrapper_refuses(case):
    """What kernel B's wrapper does not take raises before anything is
    launched: more than 32 slots a cell, another dtype, a payload that does
    not fit the grid, a payload that is not contiguous."""
    cfg = convert.config_from_fields(**vars(SimConfig(grid_size=(3, 2, 2), max_neighbors_per_cell=4)))
    data = torch.zeros((16, 4, 3, 2, 2))
    bad, error = {
        "too many slots": (torch.zeros((16, 33, 3, 2, 2)), ValueError),
        "dtype": (data.double(), TypeError),
        "shape": (torch.zeros((16, 4, 3, 2, 3)), ValueError),
        "strides": (torch.zeros((16, 4, 3, 2, 4))[..., ::2], ValueError),
    }[case]
    with pytest.raises(error):
        t_kernels._p2g_faces_cuda(bad, cfg)


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
