"""The port's z-sharded substep on its other paths, on 2 gloo ranks: the CFL
driver ``step_z`` against the port's dense ``step``, and sources (coercion
only, then a seeding jet) against the JAX package's dense substep. Helpers
and tolerances are ``test_torch_zshard.py``'s."""

import numpy as np
import torch

from libfluid_tpu.sim.sources import make_source_set
from libfluid_tpu_torch import convert
from libfluid_tpu_torch import sim as t_sim
from test_torch_substep import JaxDraws, _port, _state_arrays
from test_torch_zshard import _dense, _mk, assert_matches_dense, run_z
import torch_ranks

torch.set_num_threads(1)


def _sources(src):
    return tuple(np.asarray(a) for a in src)


def test_step_z_cfl_driver(tmp_path):
    """step_z(0.1) takes as many CFL substeps as the port's dense step and
    keeps every particle."""
    cfg, st = _mk(vz=40.0)
    tcfg, tst = _port(cfg, st)
    d_state, d_diag = t_sim.step(tst, tcfg, 0.1)
    out, diag = torch_ranks.run(2, "step_z", dict(cfg=tcfg, arrays=_state_arrays(st), dt=0.1), tmp_path)[0]
    assert diag["substeps"] == int(d_diag.substeps) >= 2
    assert diag["particle_count"] == int(np.asarray(st.active).sum()) and diag["particles_lost"] == 0
    assert np.isfinite(out["position"]).all()
    pos = out["position"][out["active"]]
    dp = d_state.position[d_state.active].numpy()
    np.testing.assert_allclose(pos.mean(axis=0), dp.mean(axis=0), atol=1e-2)


def test_zshard_sources_coerce_matches_jax_dense(tmp_path):
    """A coercing source with no seeding (no draw): the sharded substep
    equals the dense one."""
    cfg, st = _mk()
    src = make_source_set([[8, 8, 12], [8, 8, 13]], (0.0, 0.0, 40.0), coerce_velocity=True, target_density=0)
    st = st._replace(sources=src)
    ref, ref_diag = _dense(cfg)(st)
    out, diag = run_z(2, cfg, st, tmp_path, sources=_sources(src))["steps"][0]
    assert_matches_dense(ref, ref_diag, out, diag)


def test_zshard_sources_seed_jet(tmp_path):
    """A jet (testbed setup 4) seeded by the rank owning its cells with
    JAX's offsets: the first substep seeds the dense substep's particles,
    later substeps keep emitting inside the source column."""
    cfg, st = _mk()
    cells = [[8, 8, 28], [8, 9, 28], [9, 8, 28], [9, 9, 28]]
    src = make_source_set(cells, (0.0, 0.0, -30.0), coerce_velocity=True)
    st = st._replace(sources=src)
    n0 = int(np.asarray(st.active).sum())
    ref, ref_diag = _dense(cfg)(st)
    jd = JaxDraws(st.key)
    draws = [("jitter", jd.source_jitter(len(cells), cfg)), ("seed", jd.correction_seed())]
    later = t_sim.Draws(torch.Generator().manual_seed(11))
    tcfg = convert.config_from_fields(**vars(cfg))
    for _ in range(3):
        draws += [("jitter", later.source_jitter(len(cells), tcfg)), ("seed", later.correction_seed())]
    res = run_z(2, cfg, st, tmp_path, steps=4, sources=_sources(src), draws=draws)
    out, diag = res["steps"][0]
    assert diag["particle_count"] == int(ref_diag.particle_count) > n0
    assert_matches_dense(ref, ref_diag, out, diag)
    counts = [d["particle_count"] for _, d in res["steps"]]
    assert counts[-1] > counts[0]
    last = res["steps"][-1][0]
    pos = last["position"][last["active"]]
    assert np.isfinite(pos).all() and pos.min() >= 0.0 and pos.max() <= 32.0
