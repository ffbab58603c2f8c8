"""The port's z-sharded substep against the JAX package's own ``substep_z``
on a 2-device CPU mesh (it compiles in ~15 s there; ``tests/test_zshard.py``
runs it on 8 devices and is marked slow), on 2 gloo ranks: the exchange's
capacity edge (``particles_lost`` the same count), the exchange's merge of
the rows from above, and the seam's w face. The last two are where the
port departs from the JAX package, which differs there from its own dense
substep (``ROADMAP.md`` section 3). Helpers and tolerances are
``test_torch_zshard.py``'s."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from libfluid_tpu.config import TransferScheme
from libfluid_tpu.parallel import make_mesh
from libfluid_tpu.parallel.zshard import substep_z, zshard_state
from libfluid_tpu_torch import convert
from test_torch_substep import _state_arrays
from test_torch_zshard import DT, _dense, _mk, assert_matches_dense, matched, run_z
import torch_ranks

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jitted(cfg, dt):
    mesh = make_mesh(2)
    return mesh, jax.jit(lambda s: substep_z(s, cfg, dt, mesh))


def _jax_substep_z(cfg, st, dt, steps=1, capacity=None):
    mesh, fn = _jitted(cfg, dt)
    zs = zshard_state(st, cfg, mesh, per_device_capacity=capacity)
    out = []
    for _ in range(steps):
        zs, diag = fn(zs)
        out.append((zs, diag))
    return out


def test_zshard_capacity_edge_matches_jax(tmp_path):
    """An exchange buffer of 8 rows and a dense layer crossing the seam in
    one substep: the rows that do not fit are deactivated and counted in
    ``particles_lost``, the same count as the JAX package's ``substep_z``;
    the count of the rest is exact and the next substep runs."""
    cfg, st = _mk()
    cfg = dataclasses.replace(cfg, exchange_capacity=8, enable_position_correction=False)
    nzl = cfg.nz // 2
    act = np.asarray(st.active)
    pos = np.asarray(st.position)
    vel = np.array(st.velocity)
    layer = act & (pos[:, 2] >= nzl - 1.0) & (pos[:, 2] < nzl)
    assert layer.sum() > 2 * 8
    vel[layer] = (0.0, 0.0, 30.0)
    st = st._replace(velocity=jnp.asarray(vel))
    dt = 1.0 / 30.0
    (j_out, j_diag), (_, j_diag2) = _jax_substep_z(cfg, st, dt, steps=2)
    payload = dict(cfg=convert.config_from_fields(**vars(cfg)), arrays=_state_arrays(st), dt=dt, steps=2)
    res = torch_ranks.run(2, "substeps_z", payload, tmp_path)[0]
    (out, diag), (out2, diag2) = res["steps"]
    lost = diag["particles_lost"]
    assert lost > 0 and lost == int(j_diag.particles_lost)
    n0 = int(act.sum())
    assert diag["particle_count"] == int(out["active"].sum()) == n0 - lost == int(j_diag.particle_count)
    live = out["position"][out["active"]]
    assert np.isfinite(live).all() and live.min() >= 0.0 and live.max() <= 32.0
    assert np.isfinite(diag2["kinetic_energy"]) and diag2["particle_count"] == int(out2["active"].sum())
    assert diag2["particles_lost"] == int(j_diag2.particles_lost)


def test_exchange_merge_keeps_arrivals_from_above(tmp_path):
    """Rank 0 has 10 free rows and rows arrive from above (every particle
    moves -z at 30 cells/s; the exchange buffer holds 8 rows). The rows
    past the buffer are lost on both sides. The port places the 8 that
    were sent; the JAX package writes them from offset 8 of the free rows
    and drops the 6 that land past its 10."""
    from libfluid_tpu.sim import seed_box

    cfg, st = _mk()
    cfg = dataclasses.replace(cfg, exchange_capacity=8, enable_position_correction=False)
    st = seed_box(st, cfg, (0.5, 0.5, 16.0), (7.0, 7.0, 2.0))
    st = st._replace(velocity=jnp.where(st.active[:, None], jnp.asarray([0.0, 0.0, -30.0]), st.velocity))
    z = np.asarray(st.position)[np.asarray(st.active), 2]
    nzl = cfg.nz // 2
    capacity = int((z < nzl).sum()) + 10
    crossing = int(((z >= nzl) & (z < nzl + 1.0)).sum())
    assert crossing > 8
    dt = 1.0 / 30.0
    ((_, j_diag),) = _jax_substep_z(cfg, st, dt, capacity=capacity)
    payload = dict(cfg=convert.config_from_fields(**vars(cfg)), arrays=_state_arrays(st), dt=dt,
                   capacity=capacity)
    out, diag = torch_ranks.run(2, "substeps_z", payload, tmp_path)[0]["steps"][0]
    assert diag["particles_lost"] == crossing - 8
    assert int(j_diag.particles_lost) == crossing - 8 + 6
    assert diag["particle_count"] == int(np.asarray(st.active).sum()) - diag["particles_lost"]


def test_zshard_matches_jax_substep_z(tmp_path):
    """The port's substep_z against the JAX package's on a 2-device mesh
    and against the dense substep, in a scene whose free surface reaches
    the seam (z = 16) with random velocities. Particles and u, v equal all
    three; w equals JAX's off the seam plane. On the seam plane the JAX
    package keeps the upper tile's unextrapolated copy of the face, which
    differs from the dense substep's; the port takes the lower tile's
    extrapolated face, the dense value (``ROADMAP.md`` section 3)."""
    cfg, st = _mk(scheme=TransferScheme.APIC)
    rng = np.random.default_rng(0)
    v = rng.normal(0.0, 20.0, size=(cfg.particle_capacity, 3)).astype(np.float32)
    v[:, 2] += 40.0
    st = st._replace(velocity=jnp.where(st.active[:, None], jnp.asarray(v), st.velocity))
    ref, ref_diag = _dense(cfg)(st)
    ((j_out, j_diag),) = _jax_substep_z(cfg, st, DT)
    out, diag = run_z(2, cfg, st, tmp_path)["steps"][0]
    assert_matches_dense(ref, ref_diag, out, diag)

    jp, jv, op, ov = matched(j_out, out)
    np.testing.assert_allclose(op, jp, atol=2e-4)
    np.testing.assert_allclose(ov, jv, atol=5e-3)
    assert abs(diag["pressure_iterations"] - int(j_diag.pressure_iterations)) <= 1
    for name in ("u", "v"):
        np.testing.assert_allclose(out[name], np.asarray(getattr(j_out.grid, name)), atol=5e-4)
    seam = cfg.nz // 2
    off = np.arange(cfg.nz + 1) != seam
    jw, dw = np.asarray(j_out.grid.w), np.asarray(ref.grid.w)
    np.testing.assert_allclose(out["w"][:, :, off], jw[:, :, off], atol=5e-4)
    assert np.abs(jw[:, :, seam] - dw[:, :, seam]).max() > 1.0
    np.testing.assert_allclose(out["w"][:, :, seam], dw[:, :, seam], atol=5e-4)
    assert int(np.asarray(j_out.active).sum()) == diag["particle_count"]
