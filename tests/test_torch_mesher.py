"""Parity of the PyTorch port's mesher with the JAX package: the surface
node pass (kernel F's plain version) against ``_sample_surface_jnp`` on the
fixture of ``tests/test_tpu_kernels.py`` (particles outside the node grid
included), the CSR binning kernel F reads, marching cubes on one SDF fed to
both, and ``generate_mesh`` end to end.

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
    """Kernel F's algorithm in numpy over the port's CSR bins: each node
    sums the (2 cr)^3 bins b = n - cr ... n + cr - 1 of the padded grid."""
    pos_s, starts = (t.numpy() for t in t_surface.bin_particles(
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
