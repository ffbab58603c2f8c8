"""The port's slab-tiled substep (``libfluid_tpu_torch.sim.bigstep``) against
the JAX package's ``substep_tiled`` and against the port's own dense
substep, on ``tests/test_bigstep.py``'s 24 x 16 x 16 scenes: the three
schemes, several substeps at 4 slabs, the last u plane
(``test_torch_bigstep_paths.py``: the forced slab G2P path, the clustered
overflow springs, sources).

Both packages start from the same seeded state (carried over with
``libfluid_tpu_torch.convert``). A numpy-seeded velocity field stands in
for the dense substeps ``test_bigstep.py`` runs first, so that no dense
JAX substep compiles here; JAX's ``substep_tiled`` runs eagerly (one
first call compiles its operations, ~40 s; each later scene ~6 s, where
a jit would take ~15 s each). The port takes JAX's random draws
(:class:`JaxDraws`). Tolerances: against JAX those of
``test_torch_substep.py::test_substep_matches_jax``; tiled against dense
those of ``test_bigstep.py``. Both paths sort into the same rank-major
order, so rows compare in place.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu.config import SimConfig, TransferScheme
from libfluid_tpu.sim import bigstep as j_bigstep
from libfluid_tpu.sim import new_state, seed_box, transfers as j_transfers
from libfluid_tpu_torch import convert
from libfluid_tpu_torch import sim as t_sim
from libfluid_tpu_torch.sim import bigstep, kernels, slotsort
from libfluid_tpu_torch.sim import state as t_state
from test_torch_substep import JaxDraws, _port, _port_sources, _state_arrays

torch.set_num_threads(1)

DT = 0.01


def _mk(seed=0, scheme=TransferScheme.APIC, boxes=(((1.0, 1.0, 1.0), (11.0, 7.0, 7.0)),)):
    cfg = SimConfig(
        grid_size=(24, 16, 16), particle_capacity=1 << 14, gravity=(0.0, -981.0, 0.0),
        scheme=scheme, has_obstacles=False,
    )
    st = new_state(cfg, jax.random.PRNGKey(seed))
    for start, size in boxes:
        st = seed_box(st, cfg, start, size)
    rng = np.random.default_rng(seed)
    n = cfg.particle_capacity
    vel = rng.normal(0.0, 30.0, size=(n, 3)).astype(np.float32)
    aff = rng.normal(0.0, 2.0, size=(n, 3, 3)).astype(np.float32)
    act = np.asarray(st.active)
    st = st._replace(
        velocity=jnp.asarray(np.where(act[:, None], vel, 0.0)),
        affine=jnp.asarray(np.where(act[:, None, None], aff, 0.0)),
    )
    return cfg, st


def _jax_and_port(cfg, st, slabs=3):
    """JAX's substep_tiled, the port's with JAX's draws, and the port's
    dense substep with the same draws."""
    j_out, j_diag = substep_eager(st, cfg, slabs)
    tcfg, tst = _port(cfg, st)
    if st.sources.cells.shape[0] > 0:
        tst = tst._replace(sources=_port_sources(st.sources))
    t_out, t_diag = bigstep.substep_tiled(tst, tcfg, DT, slabs, draws=JaxDraws(st.key))
    d_out, d_diag = t_sim.substep(tst, tcfg, DT, draws=JaxDraws(st.key))
    return (j_out, j_diag), (t_out, t_diag), (d_out, d_diag)


def substep_eager(st, cfg, slabs):
    out = j_bigstep.substep_tiled(st, cfg, DT, slabs)
    return jax.block_until_ready(out)


def _assert_matches_jax(cfg, j, t):
    (j_out, j_diag), (t_out, t_diag) = j, t
    a = _state_arrays(j_out)
    b = convert.state_to_numpy(t_out)
    np.testing.assert_array_equal(b["active"], a["active"])
    np.testing.assert_allclose(b["position"], a["position"], rtol=0, atol=1e-4)
    for key in ("velocity", "affine", "u", "v", "w"):
        scale = float(np.max(np.abs(a[key]))) + 1e-12
        np.testing.assert_allclose(b[key], a[key], rtol=0, atol=1e-3 * scale, err_msg=key)
    for key in ("particle_count", "overflow_count", "correction_uncorrected"):
        assert int(getattr(t_diag, key)) == int(getattr(j_diag, key)), key
    assert abs(int(t_diag.pressure_iterations) - int(j_diag.pressure_iterations)) <= 1
    for key in ("kinetic_energy", "potential_energy"):
        np.testing.assert_allclose(float(getattr(t_diag, key)), float(getattr(j_diag, key)), rtol=1e-4)
    assert float(t_diag.pressure_residual) < cfg.solver.tolerance


def _assert_matches_dense(t, d):
    """test_bigstep.py's tiled-against-dense tolerances."""
    (t_out, t_diag), (d_out, d_diag) = t, d
    act = d_out.active
    assert torch.equal(act, t_out.active)
    np.testing.assert_allclose(t_out.position[act].numpy(), d_out.position[act].numpy(), rtol=0, atol=5e-4)
    np.testing.assert_allclose(t_out.velocity[act].numpy(), d_out.velocity[act].numpy(), rtol=5e-3, atol=5e-3)
    for name in ("u", "v", "w"):
        np.testing.assert_allclose(
            getattr(t_out.grid, name).numpy(), getattr(d_out.grid, name).numpy(), rtol=2e-3, atol=2e-3
        )
    assert int(t_diag.particle_count) == int(d_diag.particle_count)
    np.testing.assert_allclose(float(t_diag.kinetic_energy), float(d_diag.kinetic_energy), rtol=1e-3)


@pytest.mark.parametrize(
    "scheme", [TransferScheme.APIC, TransferScheme.PIC, TransferScheme.FLIP], ids=["apic", "pic", "flip"]
)
def test_tiled_matches_jax_and_dense(scheme):
    cfg, st = _mk(scheme=scheme)
    j, t, d = _jax_and_port(cfg, st)
    _assert_matches_jax(cfg, j, t)
    _assert_matches_dense(t, d)


def test_tiled_multi_step_stable():
    """4 slabs for 6 substeps: finite, inside the domain, the count kept;
    the first substep equal to the dense one."""
    cfg, st = _mk(1)
    tcfg, tst = _port(cfg, st)
    n0 = int(tst.active.sum())
    first = bigstep.substep_tiled(tst, tcfg, DT, 4, draws=t_sim.Draws(t_state.make_generator(5)))
    dense = t_sim.substep(tst, tcfg, DT, draws=t_sim.Draws(t_state.make_generator(5)))
    _assert_matches_dense(first, dense)
    out = first[0]
    for _ in range(5):
        out, diag = bigstep.substep_tiled(out, tcfg, DT, 4)
    assert torch.isfinite(out.position).all() and torch.isfinite(diag.kinetic_energy)
    assert int(diag.particle_count) == int(out.active.sum()) == n0
    pos = out.position[out.active]
    assert (pos >= -1e-4).all() and (pos <= torch.tensor(tcfg.domain_max) + 1e-4).all()


def test_last_u_plane_equals_jax_hi_plane():
    """The global u plane x = nx: the port takes the last slab's own face
    sx + 1 from kernel B's plain version; JAX expands the last slab again
    and runs ``_p2g_hi_plane`` (on the payload shifted into its slab-local
    x). Equal on the same slab payload."""
    for scheme in (TransferScheme.APIC, TransferScheme.PIC):
        cfg, st = _mk(6, scheme, boxes=(((14.0, 1.0, 1.0), (10.0, 9.0, 9.0)),))
        tcfg, tst = _port(cfg, st)
        slabs, (nx, ny, nz) = 3, cfg.grid_size
        sx = nx // slabs
        rs = slotsort.sort_rank_major(tst, tcfg)
        k = cfg.max_neighbors_per_cell
        ins2 = rs.ins.reshape(k, tcfg.num_cells)
        pad = ny * nz
        ins_p = torch.cat([ins2[:, :1].expand(k, pad), ins2, ins2[:, -1:].expand(k, pad)], dim=1)
        rs_p = rs._replace(ins=ins_p.reshape(-1), counts=torch.nn.functional.pad(rs.counts, (pad, pad)))
        pcfg = dataclasses.replace(tcfg, grid_size=(nx + 2, ny, nz))
        s = slabs - 1
        data = slotsort.expand_range(rs_p, pcfg, s * sx * pad, (sx + 2) * pad).reshape(16, k, sx + 2, ny, nz)
        assert float(data[3, :, sx].sum()) > 0 and float(data[3, :, sx + 1].sum()) == 0
        num, den = kernels.p2g_faces(data, bigstep._slab_cfg(tcfg, sx, s))

        # JAX's slab config has x offset 0: its payload's x is shifted
        shifted = data.clone()
        shifted[0] += -bigstep._slab_x_offset(s, sx, tcfg) * data[3]
        hn, hd = j_transfers._p2g_hi_plane(
            jnp.asarray(shifted[:, :, : sx + 1].numpy()), j_bigstep._slab_cfg(cfg, sx - 1), 0
        )
        assert float(np.abs(np.asarray(hd)).max()) > 0
        np.testing.assert_allclose(num[0][sx + 1].numpy(), np.asarray(hn), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(den[0][sx + 1].numpy(), np.asarray(hd), rtol=1e-5, atol=1e-5)
