"""Gradient of a whole substep of the PyTorch port against ``jax.grad`` of the
JAX package's substep, on the 8^3 dam-break of
``test_sim_e2e.test_substep_is_jit_and_grad_safe`` (position correction off)
and with position correction on, exactly coincident particles and the JAX
package's random draws (:class:`JaxDraws`). The loss weighs the end
positions and velocities, so the gradient flows through advection, the
sort, the slot expand, P2G, both pressure solves (forward and adjoint), G2P
and, with correction on, the springs.

Tolerance: 1e-3 of the largest gradient entry, the port's substep parity
tolerance for velocities (the adjoint CG stops at the solver's absolute
tolerance, like the forward one)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu.sim import substep
from libfluid_tpu_torch import sim as t_sim
from libfluid_tpu_torch.sim import kernels as t_kernels
from libfluid_tpu_torch.sim import pressure as t_pressure

from test_torch_substep import JaxDraws, _dam_break, _port, _with_coincident

torch.set_num_threads(1)

_W = np.array([1.0, 2.0, -0.5], np.float32)


@functools.lru_cache(maxsize=None)
def _jax_grad(cfg, dt):
    def loss(vel0, state):
        st, _ = substep(state._replace(velocity=vel0), cfg, dt)
        act = st.active.astype(st.position.dtype)
        return jnp.sum((jnp.sum(st.position * _W, -1) + 0.1 * jnp.sum(st.velocity**2, -1)) * act)

    return jax.grad(loss)


@pytest.mark.parametrize("correction", [False, True], ids=["correction-off", "correction-on"])
def test_substep_grad_matches_jax(correction):
    cfg, state = _dam_break(8)
    if correction:
        cfg = dataclasses.replace(cfg, enable_position_correction=True)
        state = _with_coincident(state, n_dup=12)
    tcfg, tstate = _port(cfg, state)

    want = np.asarray(_jax_grad(cfg, 0.05)(state.velocity, state))

    vel = tstate.velocity.clone().requires_grad_()
    t_pressure.ADJOINT_SOLVES.clear()
    t_kernels.reset_launches()
    st, _ = t_sim.substep(tstate._replace(velocity=vel), tcfg, 0.05, draws=JaxDraws(state.key))
    act = st.active.to(torch.float32)
    w = torch.from_numpy(_W)
    loss = torch.sum((torch.sum(st.position * w, -1) + 0.1 * torch.sum(st.velocity**2, -1)) * act)
    (got,) = torch.autograd.grad(loss, vel)

    active = np.asarray(state.active)
    assert np.isfinite(want).all() and np.abs(want[active]).max() > 0
    assert len(t_pressure.ADJOINT_SOLVES) == 1 and t_pressure.ADJOINT_SOLVES[0][0] > 0
    assert all(v == 0 for v in t_kernels.LAUNCHES.values())  # plain versions on the CPU
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3 * scale)
