"""The closed-form vector-Jacobian product of the mesher's node pass
(``surface._sample_surface_vjp_torch``, the arithmetic kernel F' implements:
a node pass, then a gather per particle) against ``jax.vjp`` of the JAX
package's scatter oracle ``_sample_surface_jnp`` and against the port's own
autograd of the plain version, on numpy-seeded particles.

Tolerances, as shares of the largest component of the reference cotangent:
2e-4 against the two float32 references and 1e-5 against the plain autograd
in float64. The float32 references carry the noise: their W and X
cotangents, a . x_p and a . avg, cancel at world coordinates under 1 / W of
a node that one far particle reaches (1.0e-4 from the float64 result with a
support of one cell here), where the closed form works on differences of the
support's size (1e-6 from it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu.config import MesherConfig
from libfluid_tpu.mesher import surface
from libfluid_tpu_torch.config import MesherConfig as TMesherConfig
from libfluid_tpu_torch.mesher import surface as t_surface
from libfluid_tpu_torch.sim import kernels as t_kernels

torch.set_num_threads(1)

GRID, H, OFFSET = (8, 6, 7), 0.5, (-1.0, -0.5, 0.25)
RTOL, RTOL_F64 = 2e-4, 1e-5


def _cfgs(extent):
    kw = dict(grid_size=GRID, cell_size=H, grid_offset=OFFSET, particle_extent=extent,
              particle_radius=extent / 4)
    return MesherConfig(**kw), TMesherConfig(**kw)


def _node(i, j, l):
    return np.asarray(OFFSET) + np.array([i, j, l]) * H


def _particles(case: str, extent: float):
    """A cloud over two thirds of the grid (the rest stays empty), then the
    case's particle as the last row; returns (positions, active, its row)."""
    rng = np.random.default_rng(17)
    size = np.array(GRID) * H
    pos = np.asarray(OFFSET) + rng.uniform(0.0, 1.0, (300, 3)) * size * np.array([0.66, 1.0, 1.0])
    active = np.ones(pos.shape[0] + 1, bool)
    special = {
        "random": pos[0] + 0.01,
        "on-a-node": _node(3, 2, 2),
        "lone-on-a-node": _node(8, 6, 7),                     # the far corner, no other near
        "at-extent": _node(3, 2, 2) + np.array([extent, 0.0, 0.0]),
        "outside-in-padding": _node(0, 2, 3) - np.array([0.6 * extent, 0.0, 0.1]),
        "beyond-padding": _node(0, 2, 3) - np.array([3.0 * extent + 1.0, 0.0, 0.0]),
        "inactive": pos[1] + 0.02,
        "no-particle": pos[0],
    }[case]
    if case == "lone-on-a-node":
        pos = pos[np.linalg.norm(pos - special, axis=1) > extent + 0.1]
        active = np.ones(pos.shape[0] + 1, bool)
    if case == "inactive":
        active[-1] = False
        active[::7] = False
    if case == "no-particle":
        active[:] = False
    pos = np.concatenate([pos, special[None]]).astype(np.float32)
    return pos, active, pos.shape[0] - 1


@pytest.mark.parametrize("extent", [0.5, 1.0], ids=["support-1", "support-2"])
@pytest.mark.parametrize("case", ["random", "on-a-node", "lone-on-a-node", "at-extent",
                                  "outside-in-padding", "beyond-padding", "inactive",
                                  "no-particle"])
def test_surface_vjp_closed_form_matches_jax_and_autograd(case, extent):
    cfg, tcfg = _cfgs(extent)
    pos, active, row = _particles(case, extent)
    rng = np.random.default_rng(3)
    g = rng.normal(size=tuple(n + 1 for n in GRID)).astype(np.float32)
    # eager: compiling the oracle's unrolled scatters takes longer than running them
    _, vjp = jax.vjp(lambda p: surface._sample_surface_jnp(p, jnp.asarray(active), cfg, extent / 4),
                     jnp.asarray(pos))
    (want,) = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    tp, ta, tg = torch.from_numpy(pos), torch.from_numpy(active), torch.from_numpy(g)
    got = t_surface._sample_surface_vjp_torch(tp, ta, tg, tcfg, extent / 4).numpy()
    assert np.isfinite(got).all()

    t_kernels.reset_launches()
    leaf = tp.clone().requires_grad_()
    (auto,) = torch.autograd.grad(t_surface.sample_surface(leaf, ta, tcfg, extent / 4), leaf, tg)
    assert not any(t_kernels.LAUNCHES[k] for k in ("surface", "surface_bwd_nodes", "surface_bwd"))

    leaf = tp.double().requires_grad_()
    (auto64,) = torch.autograd.grad(
        t_surface._sample_surface_torch(leaf, ta, tcfg, extent / 4), leaf, tg.double())

    for ref, what, rtol in ((want, "jax.vjp", RTOL), (auto.numpy(), "the plain autograd", RTOL),
                            (auto64.numpy(), "the plain autograd in float64", RTOL_F64)):
        scale = float(np.max(np.abs(ref)))
        if case == "no-particle":
            assert scale == 0.0 and not got.any()
            continue
        assert scale > 0
        err = float(np.max(np.abs(got - ref))) / scale
        assert err < rtol, (what, err)
    if case in ("inactive", "beyond-padding"):
        assert not got[row].any() and not want[row].any()
    if case in ("random", "on-a-node", "outside-in-padding"):
        assert np.abs(got[row]).max() > 1e-3 * np.abs(want).max()  # the placed particle is live
    if case == "at-extent":
        # the node at exactly `extent` has kl = 0 and passes nothing; the
        # particle still feels the nodes nearer to it
        d = pos[row] - _node(3, 2, 2).astype(np.float32)
        assert np.float32(1.0) - np.float32(d @ d) / np.float32(extent * extent) == 0.0


def test_bin_order_puts_the_result_back():
    """``bin_particles`` returns the sort's order with the sorted positions
    and the CSR starts: kernel F' computes in bin order and the wrapper writes
    back through it."""
    _, tcfg = _cfgs(1.0)
    pos, active, _ = _particles("inactive", 1.0)
    tp, ta = torch.from_numpy(pos), torch.from_numpy(active)
    pos_s, starts, order = t_surface.bin_particles(tp, ta, tcfg)
    assert torch.equal(pos_s, tp[order])
    assert sorted(order.tolist()) == list(range(pos.shape[0]))
    binned = int(starts[-1])
    assert binned == int(ta.sum())  # every active particle here lies inside the padded grid
    assert bool(ta[order[:binned]].all()) and not bool(ta[order[binned:]].any())
    back = torch.empty_like(tp)
    back[order] = pos_s
    assert torch.equal(back, tp)
