"""The port's z-sharded substep (``libfluid_tpu_torch.parallel.zshard``) on 2
and 4 gloo ranks against the JAX package's dense substep, as
``tests/test_zshard.py`` holds the JAX package's ``substep_z`` to it.

The ranks are processes of their own (``tests/torch_ranks.py``: a
``FileStore`` rendezvous under ``tmp_path``, a deadline that kills them);
the JAX reference runs here. Particle rows are owned by z-slab, so the
particle outputs compare as multisets (each sharded row matched to its
nearest dense row, the matching a bijection); grid arrays compare in
place, from the ranks' tiles gathered (``zshard.gather_state``). Both
start from the same numpy-seeded state and take the same correction seed
(JAX's, through ``torch_ranks.FixedDraws``). The scenes start the box at
0.5 so that the first substep's pressure solve has work (``test_zshard.py``
starts at rest 1 cell off the floor, where the right-hand side is zero).
``test_torch_zshard_paths.py`` has the CFL driver, sources, the exchange's
capacity edge and ``substep_z`` itself on a 2-device JAX mesh.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from libfluid_tpu.config import SimConfig, TransferScheme
from libfluid_tpu.sim import new_state, seed_box, substep
from libfluid_tpu_torch import convert
from test_torch_substep import JaxDraws, _state_arrays
import torch_ranks

torch.set_num_threads(1)

DT = 1.0 / 60.0


def _mk(scheme=TransferScheme.APIC, nz=32, vz=0.0, boxes=None, **kw):
    cfg = SimConfig(
        grid_size=(16, 16, nz), gravity=(0.0, -981.0, 0.0), particle_capacity=1 << 13,
        scheme=scheme, has_obstacles=False, **kw,
    )
    st = new_state(cfg, jax.random.PRNGKey(0))
    for i, (start, size) in enumerate(boxes or (((0.5, 0.5, 0.5), (7.0, 7.0, nz / 2 - 1.0)),)):
        # a jitter of its own each (seed 0 is seed_box's default)
        st = seed_box(st, cfg, start, size, rng=np.random.default_rng(i))
    if vz:
        st = st._replace(velocity=jnp.where(st.active[:, None], jnp.asarray([0.0, 0.0, vz]), st.velocity))
    return cfg, st


@functools.lru_cache(maxsize=None)
def _dense(cfg, dt=DT):
    return jax.jit(lambda s: substep(s, cfg, dt))


def _draws(st, cfg, steps):
    """The draws of `steps` dense substeps in JAX's key order: the sources'
    offsets, then the correction seed."""
    draws, out = JaxDraws(st.key), []
    n_src = st.sources.cells.shape[0]
    for _ in range(steps):
        if n_src:
            out.append(("jitter", draws.source_jitter(n_src, cfg)))
        if cfg.enable_position_correction:
            out.append(("seed", draws.correction_seed()))
    return out


def run_z(n, cfg, st, tmp_path, steps=1, **kw):
    payload = dict(cfg=convert.config_from_fields(**vars(cfg)), arrays=_state_arrays(st), dt=DT, steps=steps,
                   draws=_draws(st, cfg, steps))
    payload.update(kw)
    return torch_ranks.run(n, "substeps_z", payload, tmp_path)[0]


def matched(ref_state, out):
    """(ref pos, ref vel, out pos, out vel) of the active rows, each out row
    the nearest to its ref row (a bijection)."""
    act = np.asarray(ref_state.active)
    rp, rv = np.asarray(ref_state.position)[act], np.asarray(ref_state.velocity)[act]
    op, ov = out["position"][out["active"]], out["velocity"][out["active"]]
    assert rp.shape == op.shape
    _, idx = cKDTree(op).query(rp)
    assert np.unique(idx).size == idx.size, "nearest match not a bijection"
    return rp, rv, op[idx], ov[idx]


def assert_matches_dense(ref_state, ref_diag, out, diag, grid_atol=5e-4):
    rp, rv, op, ov = matched(ref_state, out)
    np.testing.assert_allclose(op, rp, atol=2e-4)
    np.testing.assert_allclose(ov, rv, atol=5e-3)
    for name in ("u", "v", "w"):
        np.testing.assert_allclose(out[name], np.asarray(getattr(ref_state.grid, name)), atol=grid_atol, err_msg=name)
    np.testing.assert_array_equal(out["cell_type"], np.asarray(ref_state.grid.cell_type))
    assert diag["particle_count"] == int(ref_diag.particle_count)
    assert diag["particles_lost"] == 0
    assert abs(diag["pressure_iterations"] - int(ref_diag.pressure_iterations)) <= 2
    assert diag["max_divergence"] < 1e-3


# two interleaved seedings, up to 16 particles a cell: P2G's slot-overflow rows
CLUSTERED = (((0.5, 0.5, 0.5), (5.0, 5.0, 15.0)), ((0.7, 0.7, 0.7), (5.2, 5.2, 15.2)))


@pytest.mark.parametrize(
    "scheme,n,boxes",
    [(TransferScheme.APIC, 2, None), (TransferScheme.PIC, 2, None), (TransferScheme.APIC, 4, None),
     (TransferScheme.APIC, 2, CLUSTERED)],
    ids=["apic-2", "pic-2", "apic-4", "apic-2-clustered"],
)
def test_zshard_substep_matches_jax_dense(scheme, n, boxes, tmp_path):
    cfg, st = _mk(scheme, boxes=boxes)
    ref, ref_diag = _dense(cfg)(st)
    assert int(ref_diag.pressure_iterations) > 0
    assert (int(ref_diag.overflow_count) > 0) == (boxes is not None)
    res = run_z(n, cfg, st, tmp_path)
    out, diag = res["steps"][0]
    assert_matches_dense(ref, ref_diag, out, diag)


@pytest.mark.parametrize("n", [2, 4])
def test_zshard_crossing_matches_jax_dense(n, tmp_path):
    """Every particle moves +z at 40 cells/s, so rows cross the seams in
    this substep and the exchange fires; position correction off, as in
    ``test_zshard.py`` (with it on, a crammed cell's resident subset
    depends on the row order, which the exchange changes)."""
    cfg, st = _mk(vz=40.0, enable_position_correction=False)
    ref, ref_diag = _dense(cfg)(st)
    res = run_z(n, cfg, st, tmp_path)
    out, diag = res["steps"][0]
    nzl = cfg.nz // n
    before = np.asarray(st.position)[np.asarray(st.active), 2] // nzl
    after = out["position"][out["active"], 2] // nzl
    assert not np.array_equal(np.bincount(before.astype(int), minlength=n),
                              np.bincount(after.astype(int), minlength=n)), "no row crossed a seam"
    assert_matches_dense(ref, ref_diag, out, diag)


def test_zshard_crossing_correction_bounded(tmp_path):
    """With correction on, crossings may change which rows of a crammed
    cell are resident: a bounded anti-clumping difference, not corruption
    (``test_zshard.py``'s bounds)."""
    cfg, st = _mk(vz=40.0)
    ref, _ = _dense(cfg)(st)
    out, diag = run_z(4, cfg, st, tmp_path)["steps"][0]
    assert diag["particles_lost"] == 0
    rp = np.asarray(ref.position)[np.asarray(ref.active)]
    sp = out["position"][out["active"]]
    assert rp.shape == sp.shape
    nn, _ = cKDTree(sp).query(rp)
    assert (nn > 1e-3).sum() / len(rp) < 0.10
    assert nn.max() < 0.25 * cfg.cell_size


def test_zshard_multi_substep_exchange(tmp_path):
    """Four substeps at +z 60 cells/s on 4 ranks: rows change owners,
    nothing is lost, and the run tracks the dense one in aggregate (a dam
    break is chaotic, so rows are not tracked one by one)."""
    cfg, st = _mk(vz=60.0)
    ref = st
    for _ in range(4):
        ref, _ = _dense(cfg)(ref)
    res = run_z(4, cfg, st, tmp_path, steps=4)
    out, diag = res["steps"][-1]
    nzl = cfg.nz // 4
    before = np.bincount((np.asarray(st.position)[np.asarray(st.active), 2] // nzl).astype(int), minlength=4)
    after = np.bincount((out["position"][out["active"], 2] // nzl).astype(int), minlength=4)
    assert not np.array_equal(before, after)
    assert diag["particle_count"] == int(np.asarray(ref.active).sum())
    assert all(d["particles_lost"] == 0 for _, d in res["steps"])
    op, ov = out["position"][out["active"]], out["velocity"][out["active"]]
    rp = np.asarray(ref.position)[np.asarray(ref.active)]
    rv = np.asarray(ref.velocity)[np.asarray(ref.active)]
    assert np.isfinite(op).all() and np.isfinite(ov).all()
    assert op.min() >= 0.0 and op.max() <= 32.0
    np.testing.assert_allclose(op.mean(axis=0), rp.mean(axis=0), atol=1e-2)
    ke_z, ke_r = 0.5 * (ov**2).sum(), 0.5 * (rv**2).sum()
    assert abs(ke_z - ke_r) / max(ke_r, 1.0) < 0.05
