"""Parity of the PyTorch port's P2G (kernel B's plain version and the
overflow scatter) and G2P (kernel D's plain version) with the JAX package.

Tolerances are those of the JAX package's own Pallas-vs-oracle tests: P2G
faces within 2e-5 of the largest face value after normalization, G2P within
rtol/atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu import grids
from libfluid_tpu.config import SimConfig, TransferScheme
from libfluid_tpu.sim import binning as binning_mod
from libfluid_tpu.sim import slots as slots_mod
from libfluid_tpu.sim import slotsort, transfers
from libfluid_tpu.sim.state import new_state
from libfluid_tpu_torch import convert
from libfluid_tpu_torch import grids as t_grids
from libfluid_tpu_torch.sim import kernels as t_kernels
from libfluid_tpu_torch.sim import slots as t_slots
from libfluid_tpu_torch.sim import slotsort as t_slotsort
from libfluid_tpu_torch.sim import transfers as t_transfers

torch.set_num_threads(1)

SCHEMES = [TransferScheme.APIC, TransferScheme.PIC]


def _t(x):
    return torch.from_numpy(np.array(x))


def _normalized_err(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want)) / (np.max(np.abs(want)) + 1e-9))


def _crammed(scheme):
    """The fixture of test_transfers.test_p2g_slots_exact_under_overflow,
    drawn with numpy: 200 particles in one cell (far past K), the rest
    spread over an 8^3 domain."""
    cfg = SimConfig(grid_size=(8, 8, 8), particle_capacity=1 << 12, scheme=scheme)
    rng = np.random.default_rng(5)
    n = cfg.particle_capacity
    pos = np.concatenate([
        rng.uniform(1.1, 1.9, (200, 3)), rng.uniform(0.5, 7.5, (n - 200, 3))
    ]).astype(np.float32)
    vel = rng.standard_normal((n, 3)).astype(np.float32)
    aff = (rng.standard_normal((n, 3, 3)) * 0.1).astype(np.float32)
    state = new_state(cfg, jax.random.PRNGKey(5))._replace(
        position=jnp.asarray(pos), velocity=jnp.asarray(vel),
        affine=jnp.asarray(aff), active=jnp.ones((n,), bool),
    )
    return cfg, convert.config_from_fields(**vars(cfg)), state


@pytest.mark.parametrize("scheme", SCHEMES)
def test_p2g_slots_under_overflow_matches_jax(scheme):
    """JAX's binning-path slot grid (nonzero compaction of the overflow
    rows), fed to both packages' p2g_slots."""
    cfg, tcfg, state = _crammed(scheme)
    state, bins = binning_mod.sort_by_cell(state, cfg)
    sg = slots_mod.build(state.position, state.velocity, state.affine, bins, cfg)
    assert int(jnp.sum(sg.overflow)) > 0
    want = transfers.p2g_slots(
        sg, state.position, state.velocity, state.affine, state.active, cfg
    )
    tsg = t_slots.SlotGrid(data=_t(sg.data), slot_of=_t(sg.slot_of), overflow=_t(sg.overflow))
    got = t_transfers.p2g_slots(
        tsg, _t(state.position), _t(state.velocity), _t(state.affine),
        _t(state.active), tcfg,
    )
    for g, w in zip(got, want):
        assert _normalized_err(g, w) < 2e-5


@pytest.mark.parametrize("scheme", SCHEMES)
def test_p2g_slots_overflow_window_matches_jax(scheme):
    """The substep's path: slotsort's slot grid and its contiguous overflow
    window (``overflow_start``)."""
    cfg, tcfg, state = _crammed(scheme)
    sb = slotsort.sort_and_build(state, cfg)
    st = sb.state
    want = transfers.p2g_slots(
        sb.slot_grid, st.position, st.velocity, st.affine, st.active, cfg,
        overflow_start=sb.n_kept,
    )
    s = jax.tree_util.tree_map(np.asarray, state)
    tstate = convert.state_from_numpy(
        dict(position=s.position, velocity=s.velocity, affine=s.affine,
             active=s.active, u=s.grid.u, v=s.grid.v, w=s.grid.w,
             cell_type=s.grid.cell_type, solid=s.solid, pressure=s.pressure,
             time=s.time),
        tcfg, "cpu",
    )
    tsb = t_slotsort.sort_and_build(tstate, tcfg)
    ts = tsb.state
    got = t_transfers.p2g_slots(
        tsb.slot_grid, ts.position, ts.velocity, ts.affine, ts.active, tcfg,
        overflow_start=tsb.n_kept,
    )
    for g, w in zip(got, want):
        assert _normalized_err(g, w) < 2e-5


@pytest.mark.parametrize("scheme", SCHEMES)
def test_p2g_face_sums_match_jax_oracle(scheme):
    """Kernel B's plain version (through its wrapper, CPU tensors) against
    ``transfers._p2g_slots_jnp`` on a random payload whose slots are not
    prefix-dense, on an odd grid with an offset and a non-unit cell size."""
    cfg = SimConfig(
        grid_size=(7, 5, 6), cell_size=0.7, grid_offset=(0.3, -0.2, 0.1),
        scheme=scheme, max_neighbors_per_cell=5,
    )
    nx, ny, nz = cfg.grid_size
    k = cfg.max_neighbors_per_cell
    rng = np.random.default_rng(3)
    base = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"))
    pos = (base[:, None] + rng.uniform(size=(3, k, nx, ny, nz))) * cfg.cell_size
    pos = pos + np.asarray(cfg.grid_offset).reshape(3, 1, 1, 1, 1)
    mask = (rng.uniform(size=(k, nx, ny, nz)) < 0.4).astype(np.float64)
    data = np.concatenate([
        pos, mask[None], rng.standard_normal((3, k, nx, ny, nz)),
        rng.standard_normal((9, k, nx, ny, nz)) * 0.2,
    ]) * mask[None]
    data = data.astype(np.float32)
    jn, jd = transfers._p2g_slots_jnp(jnp.asarray(data), cfg)
    tn, td = t_kernels.p2g_faces(torch.from_numpy(data), convert.config_from_fields(**vars(cfg)))
    for a in range(3):
        want = transfers._normalize(jn[a], jd[a])
        got = t_transfers._normalize(tn[a], td[a])
        assert _normalized_err(got, want) < 2e-5
        np.testing.assert_allclose(td[a].numpy(), np.asarray(jd[a]), rtol=1e-5, atol=1e-6)


def test_g2p_pic_matches_jax():
    """Kernel D's plain version against JAX's g2p_pic on random faces, with
    particles inside, on faces, and just outside the domain (clamped cell)."""
    cfg = SimConfig(grid_size=(9, 6, 7), cell_size=0.7, grid_offset=(0.3, -0.2, 0.1))
    tcfg = convert.config_from_fields(**vars(cfg))
    rng = np.random.default_rng(7)
    g = grids.zeros(cfg)
    u, v, w = (rng.standard_normal(a.shape).astype(np.float32) for a in (g.u, g.v, g.w))
    off, h = np.asarray(cfg.grid_offset), cfg.cell_size
    lo, hi = off - 0.4 * h, off + np.asarray(cfg.grid_size) * h + 0.4 * h
    pos = rng.uniform(lo, hi, size=(3000, 3))
    pos[:64] = off + rng.integers(0, 6, size=(64, 3)) * h  # exactly on faces
    pos = pos.astype(np.float32)
    want_v, want_a = transfers.g2p_pic(
        g._replace(u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w)), jnp.asarray(pos), cfg
    )
    tg = t_grids.zeros(tcfg)._replace(u=_t(u), v=_t(v), w=_t(w))
    got_v, got_a = t_transfers.g2p_pic(tg, _t(pos), tcfg)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-5, atol=1e-5)
