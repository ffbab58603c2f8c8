"""The PyTorch port's headless testbed: the five setups seed the same
particles, solids and sources as the JAX package's; the frame loop runs a
small scene with the default simulation options and exports OBJ and
points; ``--scene`` renders a PPM; ``--render-every`` renders the fluid
scene with either tracer."""

import argparse
import dataclasses

import numpy as np
import pytest
import torch

from libfluid_tpu import testbed
from libfluid_tpu_torch import testbed as t_testbed
from libfluid_tpu_torch.io.obj import load_obj
from libfluid_tpu_torch.io.point_cloud import load_points
from libfluid_tpu_torch.mesher.marching_cubes import MeshBuffers
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
                render_every=0, setup=0, seed=0, render_size=8, spp=1, algorithm="pt",
                tri_capacity=1 << 14)
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
    assert t_cli.frame_loop(cfg, state, mesher, _args(tmp_path), device="cpu") == 0
    pos, idx = load_obj(tmp_path / "mesh_00000.obj")
    assert idx.shape[0] > 100 and np.isfinite(pos).all()
    assert load_points(tmp_path / "points_00000.txt").shape == (int(state.active.sum()), 3)


def _ppm_pixels(path, size):
    data = path.read_bytes()
    header = f"P6\n{size} {size}\n255\n".encode()
    assert data.startswith(header) and len(data) == len(header) + size * size * 3
    return np.frombuffer(data[len(header):], np.uint8)


def test_render_paths_raise(tmp_path, monkeypatch):
    """The render paths the renderer's first slice refused now run on the
    CPU: ``--scene ... --algorithm bdpt``; ``run_sim`` with
    ``--render-every 1`` for both tracers (setup 0 at a quarter of its
    resolution: 25^3 cells of 2.0, the mesher at 26^3 cells of 2.0, so the
    scene holds ~1.8k triangles and gets the accelerator); and
    ``fluid_render_scene`` on its own (the glass water with reversed
    winding, setup 4's obstacle sphere)."""
    assert t_cli.main(["--scene", "cornell1", "--algorithm", "bdpt", "--render-size", "8", "--spp", "1",
                       "--out", str(tmp_path)], device="cpu") == 0
    assert _ppm_pixels(tmp_path / "cornell1.ppm", 8).max() > 0

    full_cfg, full_mesher = t_testbed.default_config, t_testbed.default_mesher_config
    monkeypatch.setattr(t_testbed, "default_config", lambda setup, capacity=None, **kw: full_cfg(
        setup, capacity or 1 << 14, grid_size=(25, 25, 25), cell_size=2.0))
    monkeypatch.setattr(t_testbed, "default_mesher_config", lambda max_triangles=1 << 18: dataclasses.replace(
        full_mesher(max_triangles), grid_size=(26, 26, 26), cell_size=2.0, particle_extent=4.0,
        particle_radius=1.0))
    for algorithm in ("pt", "bdpt"):
        out = tmp_path / algorithm
        args = _args(out, render_every=1, mesh_every=0, points_every=0, algorithm=algorithm)
        assert t_cli.run_sim(args, device="cpu") == 0
        assert _ppm_pixels(out / "frame_00000.ppm", 8).max() > 0

    cfg = t_testbed.default_config(4)
    verts = torch.tensor([[[20.0, 40.0, 20.0], [30.0, 40.0, 20.0], [20.0, 40.0, 30.0]]]).repeat(1100, 1, 1)
    verts[:, :, 1] += torch.arange(1100.0)[:, None] * 1e-3
    mesh = MeshBuffers(vertices=torch.cat([verts, torch.zeros((4, 3, 3))]), count=torch.tensor(1100))
    scene, cam = t_testbed.fluid_render_scene(mesh, cfg, 4, tri_capacity=2048, device="cpu")
    assert scene.tri_p0.shape[0] == 2048 and scene.accel is not None
    water = int(scene.tri_mat.max())
    assert float(scene.materials.ior[water]) == pytest.approx(1.7)
    rows = torch.nonzero(scene.tri_mat == water)[:, 0]
    assert rows.numel() == 1100
    # reversed winding: (p0, p1, p2) faces down, the scene's (p2, p1, p0) up
    assert float(scene.tri_normal[rows[0], 1]) == pytest.approx(1.0)
    assert int((scene.sph_mat > 0).sum()) == 1 and cam.position.shape == (3,)


@pytest.mark.parametrize("scene", ["cornell1", "glass"])
def test_run_scene_writes_a_ppm(tmp_path, scene):
    """``--scene`` on the CPU at 16^2 x 2 spp: a P6 header, the image's
    bytes, pixels that are not all black."""
    rc = t_cli.main(["--scene", scene, "--render-size", "16", "--spp", "2", "--out", str(tmp_path)],
                    device="cpu")
    assert rc == 0
    data = (tmp_path / f"{scene}.ppm").read_bytes()
    header = b"P6\n16 16\n255\n"
    assert data.startswith(header) and len(data) == len(header) + 16 * 16 * 3
    pixels = np.frombuffer(data[len(header):], np.uint8)
    assert pixels.max() > 0
