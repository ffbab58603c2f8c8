"""Parity of the PyTorch port's mesher with the JAX package: the surface
node pass (kernel F's plain version) against ``_sample_surface_jnp`` on the
fixture of ``tests/test_tpu_kernels.py`` (particles outside the node grid
included), the CSR binning kernel F reads and a numpy model of its tile
algorithm, marching cubes on one SDF fed to both, and ``generate_mesh`` end
to end.

Tolerances: SDF atol 1e-4; marching cubes ``count`` equal and vertices
atol 1e-5."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu.config import MesherConfig
from libfluid_tpu.mesher import surface
from libfluid_tpu_torch.config import MesherConfig as TMesherConfig
from libfluid_tpu_torch.mesher import surface as t_surface
from libfluid_tpu_torch.sim import kernels as t_kernels

# the packages export functions named like these modules
mc = importlib.import_module("libfluid_tpu.mesher.marching_cubes")
t_mc = importlib.import_module("libfluid_tpu_torch.mesher.marching_cubes")

torch.set_num_threads(1)

KERNEL_CFG = dict(
    grid_size=(24, 20, 28), cell_size=0.5, grid_offset=(-1.0, -0.5, 0.2),
    particle_extent=2.0, particle_radius=0.5,
)


def _cfgs(**kw):
    return MesherConfig(**kw), TMesherConfig(**kw)


def _particles(n=5000, seed=0):
    """test_tpu_kernels.py's cloud (uniform in [0.5, 8)) plus particles
    around and beyond the node grid's edges; every fifth inactive."""
    rng = np.random.default_rng(seed)
    pos = np.concatenate([
        rng.uniform(0.5, 8.0, (n, 3)),
        rng.uniform(-4.0, 17.0, (n // 4, 3)),
    ]).astype(np.float32)
    active = np.arange(pos.shape[0]) % 5 != 0
    return pos, active


def test_sample_surface_matches_jax():
    cfg, tcfg = _cfgs(**KERNEL_CFG)
    pos, active = _particles()
    # eager: compiling the oracle's 512 unrolled scatters takes longer than running them
    want = np.asarray(surface._sample_surface_jnp(jnp.asarray(pos), jnp.asarray(active), cfg, 0.5))
    t_kernels.reset_launches()
    got = t_surface.sample_surface(torch.from_numpy(pos), torch.from_numpy(active), tcfg).numpy()
    assert t_kernels.LAUNCHES["surface"] == 0  # CPU tensors take the plain version
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (want < 0).any() and (want == 1.0).any()


def _csr_gather(pos, active, cfg):
    """The gather kernel F computes, node by node, in numpy over the port's
    CSR bins: each node sums the (2 cr)^3 bins b = n - cr ... n + cr - 1 of
    the padded grid (:func:`_tile_gather` models how the kernel's tiles walk
    them)."""
    pos_s, starts, _ = (t.numpy() for t in t_surface.bin_particles(
        torch.from_numpy(pos), torch.from_numpy(active), cfg))
    cr = t_surface._support_cells(cfg)
    nx, ny, nz = cfg.grid_size
    by, bz = ny + 2 * cr, nz + 2 * cr
    off = np.asarray(cfg.grid_offset, np.float32)
    out = np.ones((nx + 1, ny + 1, nz + 1), np.float32)
    for a in range(nx + 1):
        for b in range(ny + 1):
            for c in range(nz + 1):
                node = off + np.array([a, b, c], np.float32) * cfg.cell_size
                rows = [((px * by + py) * bz) for px in range(a, a + 2 * cr)
                        for py in range(b, b + 2 * cr)]
                idx = np.concatenate([np.arange(starts[r + c], starts[r + c + 2 * cr])
                                      for r in rows])
                p = pos_s[idx]
                kl = 1.0 - np.sum((p - node) ** 2, axis=-1) / cfg.particle_extent**2
                w = np.where(kl > 0, kl**3, 0.0)
                if w.sum() > 0:
                    avg = (w[:, None] * p).sum(0) / w.sum()
                    out[a, b, c] = np.sqrt(np.sum((avg - node) ** 2) + 1e-30) - cfg.particle_radius
    return out


def test_csr_bins_reach_what_the_scatter_reaches():
    """The binning kernel F reads, walked as the kernel walks it, gives the
    scatter oracle's SDF (small grid, particles outside it included)."""
    kw = dict(KERNEL_CFG, grid_size=(8, 6, 7), particle_extent=1.3)
    cfg, tcfg = _cfgs(**kw)
    pos, active = _particles(n=600, seed=3)
    pos = pos * 0.45 - 1.0
    want = np.asarray(surface._sample_surface_jnp(jnp.asarray(pos), jnp.asarray(active), cfg, 0.5))
    got = _csr_gather(pos, active, tcfg)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (want < 0).any() and (want == 1.0).any()


def _tile_gather(pos, active, cfg, tile, cap, run=None):
    """Kernel F's algorithm (``csrc/surface.cu``) in numpy, float32
    throughout: a block per tile of nodes; the (x, y) rows of bins of the
    tile's support box, each one contiguous range of the sorted particles;
    the quick test on whole planes of rows, then on the rows' own ends;
    the box's rows `run` at a time (all of them by default), the run's
    particles as one list, row after row, staged `cap` at a time;
    a node summing the (2 cr)^2 rows of its support in the order x, y,
    particle, each row clipped to the bins its z reaches and to the chunk.
    Returns the SDF and the most chunks a tile took."""
    f32 = np.float32
    pos_s, starts, _ = (t.numpy() for t in t_surface.bin_particles(
        torch.from_numpy(pos), torch.from_numpy(active), cfg))
    cr = t_surface._support_cells(cfg)
    n2 = 2 * cr
    mx, my, mz = cfg.grid_size
    bx_n, by_n, bz_n = mx + n2, my + n2, mz + n2  # the padded bin grid
    tx, ty, tz = tile
    wx, wy, wz = tx + n2 - 1, ty + n2 - 1, tz + n2 - 1  # the box, in bins
    h, off = f32(cfg.cell_size), np.asarray(cfg.grid_offset, f32)
    inv_ext2 = f32(1.0) / f32(cfg.particle_extent**2)
    out = np.full((mx + 1, my + 1, mz + 1), np.nan, f32)
    most_chunks = 0
    for t0x in range(0, mx + 1, tx):
        for t0y in range(0, my + 1, ty):
            for t0z in range(0, mz + 1, tz):
                box = (slice(t0x, t0x + tx), slice(t0y, t0y + ty), slice(t0z, t0z + tz))
                planes = [
                    starts[(bx * by_n + min(t0y + wy, by_n)) * bz_n] - starts[(bx * by_n + t0y) * bz_n]
                    for bx in range(t0x, min(t0x + wx, bx_n))
                ]
                if not any(planes):
                    out[box] = 1.0
                    continue
                z0, z1 = min(t0z, bz_n), min(t0z + wz, bz_n)
                sums = np.zeros((tx, ty, tz, 4), f32)
                chunks = 0
                rows = wx * wy
                for r0 in range(0, rows, run or rows):  # a run of whole rows at a time
                    nr = min(run or rows, rows - r0)
                    glo, lstart, place = [], [], 0
                    for r in range(r0, r0 + nr):
                        bx, by = t0x + r // wy, t0y + r % wy
                        if bx < bx_n and by < by_n:
                            row = (bx * by_n + by) * bz_n
                            ends = starts[[row + min(t0z + z, bz_n) for z in range(wz + 1)]]
                        else:
                            ends = np.zeros(wz + 1, np.int64)
                        glo.append(int(ends[0]))
                        lstart.append(place + (ends - ends[0]))  # the bins' places in the list
                        place += int(ends[-1] - ends[0])
                    total = place
                    if total == 0:
                        continue
                    # the list's particle at place e: row r's glo[r] + e - lstart[r][0]
                    src = np.concatenate([glo[r] + np.arange(lstart[r][-1] - lstart[r][0])
                                          for r in range(nr)]).astype(np.int64)
                    for e0 in range(0, total, cap):
                        e1 = min(e0 + cap, total)
                        chunk = pos_s[src[e0:e1]]
                        chunks += 1
                        for a in range(tx):
                            for b in range(ty):
                                for c in range(tz):
                                    node = off + np.array([t0x + a, t0y + b, t0z + c], f32) * h
                                    acc = sums[a, b, c]
                                    for rx in range(n2):
                                        for ry in range(n2):
                                            r = (a + rx) * wy + b + ry - r0
                                            if not 0 <= r < nr:
                                                continue
                                            bins = lstart[r]
                                            lo, hi = max(bins[c], e0), min(bins[c + n2], e1)
                                            if lo >= hi:
                                                continue
                                            p = chunk[lo - e0:hi - e0]
                                            d = p - node
                                            d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
                                            kl = np.maximum(f32(1.0) - d2 * inv_ext2, f32(0.0))
                                            w = kl * kl * kl
                                            terms = np.concatenate([w[:, None], w[:, None] * p], axis=1)
                                            # one particle after the other, as the thread adds them
                                            acc[:] = np.add.accumulate(np.concatenate([acc[None], terms]),
                                                                       axis=0)[-1]
                        del chunk
                most_chunks = max(most_chunks, chunks)
                for a in range(min(tx, mx + 1 - t0x)):
                    for b in range(min(ty, my + 1 - t0y)):
                        for c in range(min(tz, mz + 1 - t0z)):
                            wsum = sums[a, b, c, 0]
                            value = f32(1.0)
                            if wsum > 0:
                                node = off + np.array([t0x + a, t0y + b, t0z + c], f32) * h
                                d = sums[a, b, c, 1:] / max(wsum, f32(1e-30)) - node
                                value = np.sqrt(np.sum(d * d) + f32(1e-30)) - f32(cfg.particle_radius)
                            out[t0x + a, t0y + b, t0z + c] = value
    assert not np.isnan(out).any()
    return out, most_chunks


@pytest.mark.parametrize("extent", [0.5, 1.0, 2.0], ids=["support-1", "support-2", "support-4"])
def test_surface_tile_algorithm_matches_jax_oracle(extent):
    """The tile algorithm of kernel F against ``_sample_surface_jnp`` on a
    node grid no tile divides, with a support of 1, 2 and 4 cells:
    inactive particles, particles outside the grid within and beyond the
    padding, a bin of 300 particles that takes several chunks; and the same
    bits whatever the tile's shape and the chunk size."""
    kw = dict(KERNEL_CFG, grid_size=(8, 6, 7), particle_extent=extent, particle_radius=extent / 4)
    cfg, tcfg = _cfgs(**kw)
    pos, active = _particles(n=600, seed=3)
    pos = pos * 0.45 - 1.0
    rng = np.random.default_rng(9)
    crammed = np.asarray(cfg.grid_offset) + (np.array([2.0, 3.0, 4.0]) + rng.uniform(size=(300, 3))) * 0.5
    pos = np.concatenate([pos, crammed.astype(np.float32)])
    active = np.concatenate([active, np.ones(300, bool)])
    want = np.asarray(surface._sample_surface_jnp(jnp.asarray(pos), jnp.asarray(active), cfg, extent / 4))
    got, chunks = _tile_gather(pos, active, tcfg, (4, 4, 4), cap=128)
    assert chunks > 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if extent < 2.0:  # a support of 4 cells reaches every node of this grid
        assert (want < 0).any() and (want == 1.0).any()
    again, chunks = _tile_gather(pos, active, tcfg, (3, 2, 5), cap=1 << 20)
    assert chunks == 1
    np.testing.assert_array_equal(got, again)
    # the box's rows a few at a time, as where its starts do not fit shared memory
    runs, chunks = _tile_gather(pos, active, tcfg, (4, 4, 4), cap=128, run=7)
    assert chunks > 2
    np.testing.assert_array_equal(got, runs)


def test_surface_tile_algorithm_beyond_twelve_cells():
    """The tile algorithm of kernel F with a support of 13 cells (extent
    1.625, cell 0.125), where the box's starts no longer fit a block's
    shared memory and the kernel takes its rows in runs: against
    ``_sample_surface_jnp`` and the plain version, and the same bits in runs
    of 40 rows or all at once."""
    cfg, tcfg = _cfgs(grid_size=(6, 5, 7), cell_size=0.125, grid_offset=(-0.1, 0.0, 0.05),
                      particle_extent=1.625, particle_radius=0.1)
    assert t_surface._support_cells(tcfg) == 13
    rng = np.random.default_rng(0)
    pos = rng.uniform(-0.3, 1.0, (150, 3)).astype(np.float32)
    active = np.arange(150) % 6 != 0
    # eager: the oracle's 17,576 unrolled scatters take about a minute; jitted,
    # their compile takes more memory than a test may
    want = np.asarray(surface._sample_surface_jnp(jnp.asarray(pos), jnp.asarray(active), cfg))
    plain = t_surface._sample_surface_torch(torch.from_numpy(pos), torch.from_numpy(active), tcfg).numpy()
    np.testing.assert_allclose(plain, want, rtol=0, atol=1e-4)
    got, _ = _tile_gather(pos, active, tcfg, (4, 4, 4), cap=64, run=40)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (want < 0).any()
    whole, _ = _tile_gather(pos, active, tcfg, (4, 4, 4), cap=64)
    np.testing.assert_array_equal(got, whole)


@pytest.mark.parametrize("case", ["dtype"])
def test_surface_kernel_wrapper_refuses(case):
    """What kernel F's wrapper does not take raises before anything is
    launched: positions that are not float32. It takes any support."""
    pos, active = _particles(n=50)
    _, tcfg = _cfgs(**KERNEL_CFG)
    with pytest.raises(TypeError):
        t_surface._binned(torch.from_numpy(pos).double(), torch.from_numpy(active), tcfg)


def _sphere_sdf(cfg, center, radius):
    axes = [cfg.grid_offset[a] + np.arange(cfg.grid_size[a] + 1) * cfg.cell_size for a in range(3)]
    g = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    return (np.linalg.norm(g - center, axis=-1) - radius).astype(np.float32)


@pytest.mark.parametrize(
    "grid,max_triangles",
    [((24, 24, 24), 8192), ((40, 36, 30), 1 << 14), ((24, 24, 24), 500)],
    ids=["one-block", "ragged", "capacity-drop"],
)
def test_marching_cubes_matches_jax(grid, max_triangles, monkeypatch):
    kw = dict(grid_size=grid, cell_size=0.5, grid_offset=(0.25, -0.5, 0.0),
              max_triangles=max_triangles)
    cfg, tcfg = _cfgs(**kw)
    sdf = _sphere_sdf(cfg, np.array([6.0, 6.3, 5.9]), 4.1)
    sdf = sdf + 0.3 * np.sin(3.0 * np.arange(sdf.size).reshape(sdf.shape) / sdf.size)
    sdf = sdf.astype(np.float32)
    if grid == (40, 36, 30):
        # several z-blocks of 6 cells (the block-major triangle order)
        monkeypatch.setattr(mc, "_BLOCK_CELLS", 40 * 36 * 7)
        monkeypatch.setattr(t_mc, "_BLOCK_CELLS", 40 * 36 * 7)
        assert t_mc._z_block(tcfg) == 6
    want = mc.marching_cubes(jnp.asarray(sdf), cfg)
    got = t_mc.marching_cubes(torch.from_numpy(sdf), tcfg)
    assert int(got.count) == int(want.count)
    np.testing.assert_allclose(got.vertices.numpy(), np.asarray(want.vertices), rtol=0, atol=1e-5)
    if max_triangles == 500:
        assert int(want.count) == 500  # triangles past the capacity were dropped


def test_generate_mesh_matches_jax():
    """A small drop of particles, meshed end to end by both packages."""
    kw = dict(grid_size=(28, 28, 28), cell_size=0.5, grid_offset=(-1.0, -1.0, -1.0),
              particle_extent=1.0, particle_radius=0.3, max_triangles=1 << 14)
    cfg, tcfg = _cfgs(**kw)
    rng = np.random.default_rng(4)
    pos = rng.normal(6.0, 1.8, (4000, 3)).astype(np.float32)
    active = np.ones(pos.shape[0], bool)
    want = jax.jit(lambda p, a: mc.generate_mesh(p, a, cfg))(jnp.asarray(pos), jnp.asarray(active))
    got = t_mc.generate_mesh(torch.from_numpy(pos), torch.from_numpy(active), tcfg)
    assert int(got.count) == int(want.count) > 100
    np.testing.assert_allclose(got.vertices.numpy(), np.asarray(want.vertices), rtol=0, atol=1e-4)
