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
    cfg = _cfg()
    state = _state(cfg)
    sim.substep(state, cfg, 0.01)  # the ported configuration runs
    with pytest.raises(NotImplementedError):
        sim.substep(state, dataclasses.replace(cfg, **change), 0.01)


def test_default_options_run():
    """The default SimConfig options (position correction, obstacles) with
    a source run substep and step, and the state meshes."""
    cfg = SimConfig(grid_size=(8, 8, 8), particle_capacity=512)
    assert cfg.enable_position_correction and cfg.has_obstacles
    state = _state(cfg)._replace(sources=sources.make_source_set([[6, 6, 6]], (0.0, -5.0, 0.0)))
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
