"""The PyTorch port stands alone (no JAX import), runs the default
simulation options, refuses what it has not ported instead of skipping it,
and dispatches its kernels by device."""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from libfluid_tpu_torch import sim
from libfluid_tpu_torch.config import MesherConfig, SimConfig, SolverConfig, TransferScheme
from libfluid_tpu_torch.mesher import generate_mesh, sample_surface
from libfluid_tpu_torch.sim import correction, kernels, multigrid, slotsort, sources, transfers

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import libfluid_tpu_torch, libfluid_tpu_torch.sim, libfluid_tpu_torch.convert\n"
        "from libfluid_tpu_torch.sim import slotsort, transfers, multigrid, pressure, step\n"
        "from libfluid_tpu_torch.sim import correction, collisions, sources, jitterhash\n"
        "import libfluid_tpu_torch.mesher, libfluid_tpu_torch.io, libfluid_tpu_torch.testbed\n"
        "import libfluid_tpu_torch.testbed.__main__\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)


def _cfg(**kw):
    base = dict(
        grid_size=(8, 8, 8), particle_capacity=512, gravity=(0.0, -10.0, 0.0),
        enable_position_correction=False, has_obstacles=False,
    )
    base.update(kw)
    return SimConfig(**base)


def _state(cfg):
    state = sim.new_state(cfg, "cpu")
    return sim.seed_box(state, cfg, (1.0, 1.0, 1.0), (3.0, 3.0, 3.0))


@pytest.mark.parametrize(
    "change",
    [
        dict(scheme=TransferScheme.FLIP),
        dict(solver=SolverConfig(preconditioner_dtype="bfloat16")),
    ],
    ids=["flip", "mg16"],
)
def test_unported_options_raise(change):
    """FLIP and the bfloat16 V-cycle, once refused, now run (tests/
    test_torch_flip.py holds them against the JAX package); what is still
    unported, the renderer, raises."""
    from libfluid_tpu_torch import testbed

    cfg = dataclasses.replace(_cfg(), **change)
    state, diag = sim.substep(_state(cfg), cfg, 0.01)
    assert bool(torch.isfinite(state.velocity).all())
    assert float(diag.pressure_residual) < cfg.solver.tolerance
    with pytest.raises(NotImplementedError):
        testbed.fluid_render_scene(state, cfg)


def test_default_options_run():
    """The default SimConfig options (position correction, obstacles) with
    a source run substep and step, and the state meshes."""
    cfg = SimConfig(grid_size=(8, 8, 8), particle_capacity=512)
    assert cfg.enable_position_correction and cfg.has_obstacles
    state = _state(cfg)._replace(sources=sources.make_source_set([[6, 6, 6]], (0.0, -5.0, 0.0), device="cpu"))
    n0 = int(state.active.sum())
    state, diag = sim.substep(state, cfg, 0.01)
    state, diag = sim.step(state, cfg, 0.02)
    assert int(diag.particle_count) > n0 and int(diag.correction_uncorrected) == 0
    mesh = generate_mesh(state.position, state.active, MesherConfig(grid_size=(16, 16, 16)))
    assert int(mesh.count) > 0


def test_wrappers_dispatch_by_device():
    """CPU tensors take the plain versions and count no launch; a tensor on
    a device with neither kernel nor plain version raises."""
    cfg = _cfg()
    state = _state(cfg)
    kernels.reset_launches()
    sim.substep(state, cfg, 0.01)
    assert all(v == 0 for v in kernels.LAUNCHES.values())

    meta = torch.empty((16, 4), device="meta")
    with pytest.raises(RuntimeError):
        slotsort.expand(meta, torch.empty(4, dtype=torch.int32, device="meta"),
                        torch.empty(2, dtype=torch.int32, device="meta"))
    with pytest.raises(RuntimeError):
        kernels.p2g_faces(torch.empty((16, 1, 8, 8, 8), device="meta"), cfg)
    lvl = multigrid.build_levels(torch.zeros((8, 8, 8), dtype=torch.int8, device="meta"))[0]
    x = torch.empty((8, 8, 8), device="meta")
    with pytest.raises(RuntimeError):
        multigrid.apply_level(lvl, x)
    g = state.grid
    with pytest.raises(RuntimeError):
        transfers.g2p_pic(g._replace(u=g.u.to("meta"), v=g.v.to("meta"), w=g.w.to("meta")),
                          state.position.to("meta"), cfg)
    with pytest.raises(ValueError):  # mixed devices
        transfers.g2p_pic(g, state.position.to("meta"), cfg)
    pos = torch.empty((3, 4, 8, 8, 8), device="meta")
    with pytest.raises(RuntimeError):
        correction._springs(pos, pos[0], 1, (0, 0, 0), 0.5, cfg)
    with pytest.raises(ValueError):
        kernels.correction_springs(torch.zeros(pos.shape), torch.zeros(pos.shape[1:]), 0.5, 1)
    with pytest.raises(RuntimeError):
        sample_surface(torch.empty((4, 3), device="meta"),
                       torch.empty(4, dtype=torch.bool, device="meta"), MesherConfig())


def _constructors():
    """name -> constructor taking only `device`, one per constructor that
    allocates the port's tensors."""
    import numpy as np

    from libfluid_tpu_torch import convert, grids, testbed
    from libfluid_tpu_torch.sim import jitterhash, state as state_mod

    cfg = _cfg()
    arrays = convert.state_to_numpy(sim.new_state(cfg, "cpu"))
    return {
        "new_state": lambda device: sim.new_state(cfg, device).position,
        "empty_sources": lambda device: state_mod.empty_sources(device).cells,
        "grids.zeros": lambda device: grids.zeros(cfg, device).u,
        "state_from_numpy": lambda device: convert.state_from_numpy(arrays, cfg, device).position,
        "build_setup": lambda device: testbed.build_setup(
            4, testbed.default_config(4, capacity=1 << 12), device=device)[1].sources.cells,
        "make_source_set": lambda device: sources.make_source_set(
            np.array([[1, 2, 3]]), (0.0, 1.0, 0.0), device=device).cells,
        "jitter_field": lambda device: jitterhash.jitter_field(
            7, 2, (3, 3, 3), (0, 0, 0), torch.float32, device),
    }


@pytest.mark.parametrize("name", [
    "new_state", "empty_sources", "grids.zeros", "state_from_numpy", "build_setup",
    "make_source_set", "jitter_field",
])
def test_constructors_default_to_the_card(name):
    """``device=None`` is the CUDA card and never the CPU: without a card it
    raises a RuntimeError that names the argument; ``"cpu"`` builds on the
    CPU."""
    make = _constructors()[name]
    assert make("cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert make(None).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device=None"):
            make(None)
