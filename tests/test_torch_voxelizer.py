"""The port's voxelizer (``libfluid_tpu_torch.voxelizer``) against the JAX
package's on the cases of ``tests/test_voxelizer.py``: the same surface,
exterior and interior masks and offsets (exact), on the CPU; and the
properties those tests check (the box's 3x3x3 core, the flood fill
against a depth-first oracle, the sphere's interior volume, obstacles on
the simulation grid and cropped at its edge)."""

import numpy as np
import pytest
import torch

from libfluid_tpu import voxelizer as jvox
from libfluid_tpu.config import SimConfig as JSimConfig
from libfluid_tpu.renderer.scene import unit_box
from libfluid_tpu_torch import voxelizer
from libfluid_tpu_torch.config import SimConfig
from libfluid_tpu_torch.renderer import loops

from test_voxelizer import _bfs_exterior, _uv_sphere

torch.set_num_threads(1)

_MESHES = {
    "box": lambda: (unit_box()[0] * 4.0 + 2.0, unit_box()[1]),
    "sphere": lambda: _uv_sphere(radius=3.0, center=(4.0, 4.5, 4.2)),
    "fine sphere": lambda: _uv_sphere(radius=4.0, center=(6.0, 6.0, 6.0), n_theta=24, n_phi=48),
}


@pytest.mark.parametrize("name", sorted(_MESHES))
def test_voxelize_equals_jax(name):
    pos, idx = _MESHES[name]()
    want = jvox.voxelize(pos, idx, 1.0)
    loops.reset_host_reads()
    got = voxelizer.voxelize(pos, idx, 1.0, device="cpu")
    for field in ("surface", "exterior", "interior"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field)
    assert got.offset == want.offset and got.cell_size == want.cell_size
    # the flood fill reads its flag every few sweeps, not every sweep
    assert 1 <= loops.HOST_READS["count"] <= 4


def test_box_voxelization_interior():
    pos, idx = _MESHES["box"]()
    vox = voxelizer.voxelize(pos, idx, 1.0, device="cpu")
    interior = vox.interior.numpy()
    coords = np.argwhere(interior) + np.asarray(vox.offset)
    assert coords.shape[0] == 27 and coords.min() == 1 and coords.max() == 3
    assert not np.any(vox.exterior.numpy() & interior)


def test_exterior_matches_bfs_oracle():
    pos, idx = _MESHES["sphere"]()
    vox = voxelizer.voxelize(pos, idx, 1.0, device="cpu")
    np.testing.assert_array_equal(vox.exterior.numpy(), _bfs_exterior(vox.surface.numpy()))


def test_sphere_interior_volume():
    r = 4.0
    pos, idx = _MESHES["fine sphere"]()
    interior = int(voxelizer.voxelize(pos, idx, 1.0, device="cpu").interior.sum())
    assert 4.0 / 3.0 * np.pi * (r - 1.7) ** 3 < interior < 4.0 / 3.0 * np.pi * r**3


@pytest.mark.parametrize("case", ["inside", "cropped"])
def test_obstacle_cells_equal_jax(case):
    """``obstacle_cells`` on the simulation grid, equal to the JAX package's;
    inside: every solid cell's centre within the sphere; cropped: a sphere
    over the grid's corner keeps only the overlapping octant."""
    if case == "inside":
        kw = dict(grid_size=(16, 16, 16), cell_size=0.5, grid_offset=(-1.0, -1.0, -1.0), particle_capacity=8)
        pos, idx = _uv_sphere(radius=1.5, center=(2.5, 2.5, 2.5))
    else:
        kw = dict(grid_size=(8, 8, 8), cell_size=1.0, particle_capacity=8)
        pos, idx = _uv_sphere(radius=3.0, center=(0.0, 0.0, 0.0))
    cfg = SimConfig(**kw)
    mask = voxelizer.obstacle_cells(pos, idx, cfg, device="cpu").numpy()
    np.testing.assert_array_equal(mask, np.asarray(jvox.obstacle_cells(pos, idx, JSimConfig(**kw))))
    assert mask.shape == cfg.grid_size and mask.sum() > 0
    if case == "inside":
        centers = (np.argwhere(mask) + 0.5) * cfg.cell_size + np.asarray(cfg.grid_offset)
        assert np.linalg.norm(centers - 2.5, axis=-1).max() < 1.5
    else:
        assert not mask[4:].any()


def test_surface_chunks_do_not_change_the_mask(monkeypatch):
    """The SAT runs in chunks of triangles; one pair a chunk gives the
    mask of one chunk for all."""
    pos, idx = _MESHES["sphere"]()
    whole = voxelizer.voxelize(pos, idx, 1.0, device="cpu")
    monkeypatch.setattr(voxelizer, "_PAIRS_PER_CHUNK", 1)
    small = voxelizer.voxelize(pos, idx, 1.0, device="cpu")
    assert torch.equal(whole.surface, small.surface) and torch.equal(whole.interior, small.interior)
