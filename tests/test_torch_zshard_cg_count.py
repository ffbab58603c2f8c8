"""CG iterations of one substep, dense and z-sharded on one device, in the
JAX package and in the port, from the same state (on the CPU).

The dam-break of ``chip_smoke.py`` (``bench.py``'s 128^3 benchmark scene:
no obstacles, APIC, dt 0.02) at n^3 cells: the JAX package's dense substep
takes the seeded box one substep on (position correction off: it runs
after the solve, so it does not change the count of the substep counted),
then four substeps run from that state: JAX's ``substep`` and
``substep_z`` on a one-device mesh, the port's ``substep`` and
``substep_z`` on one gloo rank. The sharded levels restrict and prolong
piecewise constantly in both packages, so ``substep_z`` may take more
iterations than ``substep``; the port holds JAX's count within one in
either. The test runs at 32^3 (~40 s in one worker); for another size:

    PYTHONPATH=.:tests JAX_PLATFORMS=cpu python tests/test_torch_zshard_cg_count.py [n]
"""

import os
import sys
import tempfile

import jax
import torch

from libfluid_tpu.config import SimConfig, TransferScheme
from libfluid_tpu.parallel import make_mesh
from libfluid_tpu.parallel.zshard import substep_z, zshard_state
from libfluid_tpu.sim import new_state, seed_box, substep
from libfluid_tpu_torch import convert
from libfluid_tpu_torch import sim as t_sim
from test_torch_substep import _state_arrays
import torch_ranks

torch.set_num_threads(1)
DT = 0.02


def cg_counts(n: int, tmp) -> dict:
    """The CG iterations of the four substeps at n^3, by name."""
    cfg = SimConfig(grid_size=(n, n, n), cell_size=1.0, gravity=(0.0, -981.0, 0.0),
                    particle_capacity=n ** 3, scheme=TransferScheme.APIC,
                    has_obstacles=False, enable_position_correction=False)
    st = seed_box(new_state(cfg, jax.random.PRNGKey(0)), cfg, (1.0, 1.0, 1.0), (n / 2 - 1.0,) * 3)
    dense = jax.jit(lambda s: substep(s, cfg, DT))
    st, _ = dense(st)
    mesh = make_mesh(1)
    tcfg = convert.config_from_fields(**vars(cfg))
    arrays = _state_arrays(st)
    _, jd = dense(st)
    _, jz = jax.jit(lambda s: substep_z(s, cfg, DT, mesh))(zshard_state(st, cfg, mesh))
    _, td = t_sim.substep(convert.state_from_numpy(arrays, tcfg, "cpu"), tcfg, DT)
    tz = torch_ranks.run(1, "substeps_z", dict(cfg=tcfg, arrays=arrays, dt=DT), tmp, timeout=600.0)
    return {
        "JAX substep": int(jd.pressure_iterations),
        "JAX substep_z, one device": int(jz.pressure_iterations),
        "port substep": int(td.pressure_iterations),
        "port substep_z, one rank": tz[0]["steps"][0][1]["pressure_iterations"],
    }


def test_one_rank_cg_counts_match_jax(tmp_path):
    """The port's dense and one-rank sharded substeps take JAX's CG
    iterations within one; the reference's sharded count is its own."""
    c = cg_counts(32, tmp_path)
    assert c["JAX substep"] > 0
    assert abs(c["port substep"] - c["JAX substep"]) <= 1, c
    assert abs(c["port substep_z, one rank"] - c["JAX substep_z, one device"]) <= 1, c


if __name__ == "__main__":
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    size = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    with tempfile.TemporaryDirectory() as tmp:
        print(f"{size}^3 second substep CG iterations: {cg_counts(size, tmp)}", flush=True)
