"""The port's DCC node graph (``libfluid_tpu_torch.dcc``) on the cases of
``tests/test_dcc.py`` at 12^3 on the CPU: the frame cache grows
monotonically and a scrub backwards returns the cached frame; an
attribute change clears it; the mesher downstream of the grid meshes the
seeded region and is dirtied by a time change; the point-cloud loader;
the manipulator's overlay; and an obstacle's voxelized interior becomes
solid in the grid's first frame. Against the JAX package on the same
inputs: the mesher node's triangles on a point cloud both loaders read
(count equal, vertices within 1e-4, the tolerance of
``test_torch_mesher.py::test_generate_mesh_matches_jax``), and the grid
node's first-frame solid mask and cell types for a sphere obstacle against
the JAX voxelizer's interior embedded in the grid and installed by JAX's
``set_solid`` (equal). JAX's ``GridNode`` itself is not run: it indexes
the mask ``obstacle_cells`` returns as if it were a list of cells."""

import numpy as np
import pytest
import torch

import jax
from libfluid_tpu import dcc as jdcc
from libfluid_tpu import voxelizer as jvoxelizer
from libfluid_tpu.config import MesherConfig as JMesherConfig
from libfluid_tpu.config import SimConfig as JSimConfig
from libfluid_tpu.sim.state import new_state as jnew_state
from libfluid_tpu.sim.state import set_solid as jset_solid
from libfluid_tpu_torch import dcc
from libfluid_tpu_torch.config import MesherConfig
from libfluid_tpu_torch.io.point_cloud import save_points
from libfluid_tpu_torch.sim import seed_box

from test_voxelizer import _uv_sphere

torch.set_num_threads(1)

_GRID = dict(grid_size=(12, 12, 12), gravity=(0.0, -100.0, 0.0), particle_capacity=1 << 12,
             frames_per_second=60.0, device="cpu")


@pytest.fixture(scope="module")
def grid_node():
    g = dcc.GridNode(**_GRID)
    g.add_seeder(lambda s, c: seed_box(s, c, (2.0, 6.0, 2.0), (4.0, 4.0, 4.0)))
    return g


def test_frame_cache_monotone_and_scrub(grid_node):
    grid_node.set_time(2)
    p2 = grid_node.evaluate()
    assert len(grid_node._cache) == 3
    grid_node.set_time(4)
    p4 = grid_node.evaluate()
    assert len(grid_node._cache) == 5
    grid_node.set_time(2)
    np.testing.assert_array_equal(p2, grid_node.evaluate())
    assert len(grid_node._cache) == 5
    assert p4[:, 1].mean() < p2[:, 1].mean()


def test_attribute_change_invalidates_cache(grid_node):
    grid_node.set_time(1)
    grid_node.evaluate()
    assert len(grid_node._cache) > 0
    grid_node.set(gravity=(0.0, -50.0, 0.0))
    assert len(grid_node._cache) == 0
    assert grid_node.evaluate().shape[1] == 3


def test_pipeline_mesher_downstream():
    grid, mesher = dcc.create_simulation_pipeline(
        grid_kwargs=_GRID,
        mesher_cfg=MesherConfig(grid_size=(24, 24, 24), cell_size=0.5, particle_extent=1.0, max_triangles=1 << 14),
    )
    assert mesher.device == torch.device("cpu")
    grid.add_seeder(lambda s, c: seed_box(s, c, (2.0, 2.0, 2.0), (6.0, 4.0, 6.0)))
    grid.set_time(0)
    verts, count = mesher.evaluate()
    assert count > 0
    active = verts[:count]
    assert np.isfinite(active).all() and active[..., 1].max() < 8.0
    assert mesher._dirty is False
    grid.set_time(1)
    assert mesher._dirty is True


def test_point_cloud_loader(tmp_path):
    pts = np.random.default_rng(0).uniform(0, 10, (17, 3))
    path = str(tmp_path / "points.txt")
    save_points(path, pts)
    np.testing.assert_allclose(dcc.PointCloudLoaderNode(path).evaluate(), pts, rtol=1e-6)


def test_grid_manipulator_overlay():
    grid, _ = dcc.create_simulation_pipeline(grid_kwargs=dict(grid_size=(12, 12, 12), particle_capacity=1 << 10),
                                             device="cpu")
    grid.add_seeder(lambda s, cfg: seed_box(s, cfg, (1.0, 1.0, 1.0), (5.0, 5.0, 5.0)))
    manip = dcc.GridManipulatorNode(grid)
    grid.set_time(1)
    out = manip.evaluate()
    assert out["box_segments"].shape == (12, 2, 3)
    assert out["particles"].shape[1] == 3 and out["particles"].shape[0] > 0
    lo = out["box_segments"].min(axis=(0, 1))
    hi = out["box_segments"].max(axis=(0, 1))
    assert np.all(out["particles"] >= lo - 1e-6) and np.all(out["particles"] <= hi + 1e-6)
    grid.set_time(2)
    assert manip.evaluate()["particles"].shape[0] > 0


def test_obstacle_becomes_solid():
    """A sphere obstacle: the voxelizer node's mask is the grid node's solid
    cells."""
    pos, idx = _uv_sphere(radius=2.5, center=(6.0, 4.0, 6.0))
    grid = dcc.GridNode(**_GRID)
    grid.set(obstacles=((pos, idx),))
    grid.set_time(0)
    grid.evaluate()
    vox = dcc.VoxelizerNode(pos, idx, grid._config(), device="cpu").evaluate()
    assert vox.sum() > 0
    np.testing.assert_array_equal(grid.state.solid.numpy(), vox)


def test_mesher_node_matches_jax(tmp_path):
    """A point cloud read by each package's loader node and meshed by its
    mesher node: the same triangle count, vertices within 1e-4."""
    pos = np.random.default_rng(4).normal(6.0, 1.8, (3000, 3)).astype(np.float32)
    path = str(tmp_path / "points.txt")
    save_points(path, pos)
    kw = dict(grid_size=(28, 28, 28), cell_size=0.5, grid_offset=(-1.0, -1.0, -1.0), particle_extent=1.0,
              particle_radius=0.3, max_triangles=1 << 14)
    got_v, got_n = dcc.MesherNode(dcc.PointCloudLoaderNode(path), MesherConfig(**kw), device="cpu").evaluate()
    want_v, want_n = jdcc.MesherNode(jdcc.PointCloudLoaderNode(path), JMesherConfig(**kw)).evaluate()
    assert got_n == want_n > 100
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-4)


def test_obstacle_solid_matches_jax():
    """The grid node's first frame with a sphere obstacle: its solid mask
    and cell types equal JAX's ``set_solid`` of the JAX voxelizer's
    interior embedded in the grid."""
    pos, idx = _uv_sphere(radius=2.5, center=(6.0, 4.0, 6.0))
    grid = dcc.GridNode(**_GRID)
    grid.set(obstacles=((pos, idx),))
    grid.set_time(0)
    grid.evaluate()
    jcfg = JSimConfig(grid_size=_GRID["grid_size"], gravity=_GRID["gravity"],
                      particle_capacity=_GRID["particle_capacity"])
    vox = jvoxelizer.voxelize(pos, idx, jcfg.cell_size, jcfg.grid_offset)
    mask = jvoxelizer.embed(vox.interior, vox.offset, jcfg.grid_size)
    want = jset_solid(jnew_state(jcfg, jax.random.PRNGKey(0)), mask)
    assert int(np.asarray(want.solid).sum()) > 0
    np.testing.assert_array_equal(grid.state.solid.numpy(), np.asarray(want.solid))
    np.testing.assert_array_equal(grid.state.grid.cell_type.numpy(), np.asarray(want.grid.cell_type))
