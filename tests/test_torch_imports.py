"""The PyTorch port stands alone (no JAX import), refuses what it has not
ported instead of skipping it, and dispatches its kernels by device."""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from libfluid_tpu_torch import sim
from libfluid_tpu_torch.config import SimConfig, SolverConfig, TransferScheme
from libfluid_tpu_torch.sim import kernels, multigrid, slotsort, transfers

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import libfluid_tpu_torch, libfluid_tpu_torch.sim, libfluid_tpu_torch.convert\n"
        "from libfluid_tpu_torch.sim import slotsort, transfers, multigrid, pressure, step\n"
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
        dict(enable_position_correction=True),
        dict(scheme=TransferScheme.FLIP),
        dict(has_obstacles=True),
        dict(solver=SolverConfig(preconditioner_dtype="bfloat16")),
    ],
    ids=["correction", "flip", "obstacles", "mg16"],
)
def test_unported_options_raise(change):
    cfg = _cfg()
    state = _state(cfg)
    sim.substep(state, cfg, 0.01)  # the ported configuration runs
    with pytest.raises(NotImplementedError):
        sim.substep(state, dataclasses.replace(cfg, **change), 0.01)


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
