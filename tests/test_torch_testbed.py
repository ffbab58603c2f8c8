"""The PyTorch port's headless testbed: the five setups seed the same
particles, solids and sources as the JAX package's; the frame loop runs a
small scene with the default simulation options and exports OBJ and
points; what needs the renderer raises."""

import argparse
import dataclasses

import numpy as np
import pytest
import torch

from libfluid_tpu import testbed
from libfluid_tpu_torch import testbed as t_testbed
from libfluid_tpu_torch.io.obj import load_obj
from libfluid_tpu_torch.io.point_cloud import load_points
from libfluid_tpu_torch.sim import seed_box
from libfluid_tpu_torch.testbed import __main__ as t_cli

torch.set_num_threads(1)


@pytest.mark.parametrize("setup", sorted(testbed.SETUP_NAMES))
def test_build_setup_equals_jax(setup):
    cfg, state = testbed.build_setup(setup, seed=3)
    tcfg, tstate = t_testbed.build_setup(setup, seed=3, device="cpu")
    assert dataclasses.asdict(tcfg)["grid_size"] == cfg.grid_size
    assert tcfg.particle_capacity == cfg.particle_capacity
    assert t_testbed.SETUP_NAMES == testbed.SETUP_NAMES
    for name in ("position", "velocity", "active", "solid"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(), np.asarray(getattr(state, name)))
    np.testing.assert_array_equal(tstate.grid.cell_type.numpy(), np.asarray(state.grid.cell_type))
    for a, b in zip(tstate.sources, state.sources):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = dataclasses.asdict(testbed.default_mesher_config())
    assert dataclasses.asdict(t_testbed.default_mesher_config()) == want


def _args(tmp_path, **kw):
    base = dict(frames=1, fps=60.0, out=str(tmp_path), mesh_every=1, points_every=1,
                render_every=0, setup=0, seed=0)
    base.update(kw)
    return argparse.Namespace(**base)


def test_frame_loop_exports_mesh_and_points(tmp_path):
    """Default SimConfig options (position correction and obstacles on) on
    a 12^3 drop, meshed at cell 0.5."""
    cfg = t_testbed.default_config(0, capacity=1 << 12, grid_size=(12, 12, 12))
    assert cfg.enable_position_correction and cfg.has_obstacles
    _, state = t_testbed.build_setup(0, cfg, device="cpu")
    state = seed_box(state, cfg, (3.0, 4.0, 3.0), (5.0, 5.0, 5.0))
    mesher = dataclasses.replace(
        t_testbed.default_mesher_config(max_triangles=1 << 14), grid_size=(26, 26, 26)
    )
    assert t_cli.frame_loop(cfg, state, mesher, _args(tmp_path)) == 0
    pos, idx = load_obj(tmp_path / "mesh_00000.obj")
    assert idx.shape[0] > 100 and np.isfinite(pos).all()
    assert load_points(tmp_path / "points_00000.txt").shape == (int(state.active.sum()), 3)


def test_render_paths_raise(tmp_path):
    with pytest.raises(NotImplementedError):
        t_cli.main(["--scene", "cornell1"])
    with pytest.raises(NotImplementedError):
        t_cli.run_sim(_args(tmp_path, render_every=1))
    with pytest.raises(NotImplementedError):
        t_testbed.fluid_render_scene(None, None, 4)
