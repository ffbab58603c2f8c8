"""The closed-form vector-Jacobian product of the correction springs
(``correction._springs_vjp_torch``, the arithmetic kernel E' implements)
against ``jax.vjp`` of the JAX package's oracle ``_springs_jnp`` and against
the port's own autograd of the plain version, on numpy-seeded slot grids.

Tolerance: 1e-4 of the largest component of the reference cotangent. The
Jacobian has a 1/d^3 term, so the closest pair sets the scale, and the
oracle's form ``x_i * wsum - wnbr`` cancels at world coordinates where the
closed form works on differences; float32 leaves the two ~1e-5 apart."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu.config import SimConfig
from libfluid_tpu.sim import correction
from libfluid_tpu_torch import convert
from libfluid_tpu_torch.sim import correction as t_correction
from libfluid_tpu_torch.sim import kernels as t_kernels

torch.set_num_threads(1)

KC, SHAPE, H, SEED = 6, (6, 5, 7), 1.0, 4242
RE2 = H * H / 2.0
CFG = SimConfig(grid_size=SHAPE, cell_size=H, particle_capacity=64)
TCFG = convert.config_from_fields(**vars(CFG))
RTOL = 1e-4

_jax_vjp = jax.jit(lambda p, m, g: jax.vjp(
    lambda p_, m_: correction._springs_jnp(p_, m_, RE2, jnp.int32(SEED), CFG), p, m)[1](g))


def _slots(case: str):
    """Slots of random counts with in-cell positions at least 0.05 from the
    cell's faces, zeros in the empty slots, and the case's pairs placed."""
    rng = np.random.default_rng(21)
    counts = rng.integers(0, KC + 1, size=SHAPE)
    counts[2, 2, 3] = max(counts[2, 2, 3], 3)
    counts[3, 2, 3] = max(counts[3, 2, 3], 1)
    if case == "empty-grid":
        counts[:] = 0
    mask = (np.arange(KC)[:, None, None, None] < counts[None]).astype(np.float32)
    cell = np.stack(np.meshgrid(*(np.arange(n) for n in SHAPE), indexing="ij"))
    pos = (cell[:, None] + rng.uniform(0.05, 0.95, (3, KC) + SHAPE)) * H
    if case == "coincident":
        pos[:, 1, 2, 2, 3] = pos[:, 0, 2, 2, 3]          # inside a cell
        pos[:, 2, 2, 2, 3] = (3.0, 2.5, 3.5)             # on a face, and its twin
        pos[:, 0, 3, 2, 3] = (3.0, 2.5, 3.5)             # in the neighbour cell
    if case == "at-re":
        pos[:, 0, 2, 2, 3] = (2.25, 2.25, 3.5)           # |r|^2 = 0.5 = re^2 exactly
        pos[:, 1, 2, 2, 3] = (2.75, 2.75, 3.5)
    if case == "close-pair":
        pos[:, 1, 2, 2, 3] = pos[:, 0, 2, 2, 3] + np.float32(1e-2)
    pos = (pos * mask[None]).astype(np.float32)
    g = rng.normal(size=pos.shape).astype(np.float32)
    return pos, mask, g


def _assert_close(got, want, what):
    scale = float(np.max(np.abs(want)))
    if scale == 0.0:
        assert not np.any(got), what
        return
    err = float(np.max(np.abs(got - want))) / scale
    assert err < RTOL, (what, err)


@pytest.mark.parametrize("case", ["random", "coincident", "at-re", "close-pair", "empty-grid"])
def test_springs_vjp_closed_form_matches_jax_and_autograd(case):
    pos, mask, g = _slots(case)
    if case == "at-re":
        r = pos[:, 0, 2, 2, 3] - pos[:, 1, 2, 2, 3]
        assert np.float32(1.0) - np.float32(r @ r) / np.float32(RE2) == 0.0
    want_p, want_m = (np.asarray(a) for a in _jax_vjp(*(jnp.asarray(a) for a in (pos, mask, g))))
    tp, tm, tg = (torch.from_numpy(a) for a in (pos, mask, g))
    got_p, got_m = t_correction._springs_vjp_torch(tp, tm, tg, RE2, SEED, TCFG)
    _assert_close(got_p.numpy(), want_p, "d pos against jax.vjp")
    _assert_close(got_m.numpy(), want_m, "d mask against jax.vjp")
    assert not got_p.numpy()[:, mask == 0].any()  # an empty slot's position gets nothing

    # the port's own autograd of the plain version, through the Function (CPU
    # tensors take it, and count no launch)
    t_kernels.reset_launches()
    lp, lm = tp.clone().requires_grad_(), tm.clone().requires_grad_()
    out = t_correction._springs(lp, lm, SEED, (0, 0, 0), RE2, TCFG)
    auto_p, auto_m = torch.autograd.grad(out, (lp, lm), tg)
    assert t_kernels.LAUNCHES["correction_bwd"] == 0 and t_kernels.LAUNCHES["correction"] == 0
    _assert_close(got_p.numpy(), auto_p.numpy(), "d pos against the plain autograd")
    _assert_close(got_m.numpy(), auto_m.numpy(), "d mask against the plain autograd")
    if case == "coincident":
        # the jitter's part of d mask is live: another seed moves it
        other = t_correction._springs_vjp_torch(tp, tm, tg, RE2, SEED + 1, TCFG)[1].numpy()
        assert np.max(np.abs(other - got_m.numpy())) > 1e-3
    if case == "empty-grid":
        assert not got_p.any() and not got_m.any()


def test_springs_vjp_with_an_origin_and_smaller_cells():
    """A global origin for the jitter hash and a cell size that is not 1
    (the oracle is called eagerly here: one more shape)."""
    h, origin = 0.8, (5, -3, 1000)
    cfg = SimConfig(grid_size=(4, 4, 5), cell_size=h, particle_capacity=64)
    tcfg = convert.config_from_fields(**vars(cfg))
    rng = np.random.default_rng(5)
    counts = rng.integers(1, 5, size=cfg.grid_size)
    mask = (np.arange(4)[:, None, None, None] < counts[None]).astype(np.float32)
    cell = np.stack(np.meshgrid(*(np.arange(n) for n in cfg.grid_size), indexing="ij"))
    pos = (cell[:, None] + rng.uniform(0.05, 0.95, (3, 4) + cfg.grid_size)) * h
    pos[:, 1, 1, 1, 1] = pos[:, 0, 1, 1, 1]
    pos = (pos * mask[None]).astype(np.float32)
    g = rng.normal(size=pos.shape).astype(np.float32)
    re2 = h * h / 2.0
    _, vjp = jax.vjp(lambda p, m: correction._springs_jnp(
        p, m, re2, jnp.int32(99), cfg, origin=jnp.asarray(origin, jnp.int32)),
        jnp.asarray(pos), jnp.asarray(mask))
    want_p, want_m = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    got_p, got_m = t_correction._springs_vjp_torch(
        torch.from_numpy(pos), torch.from_numpy(mask), torch.from_numpy(g), re2, 99, tcfg, origin)
    _assert_close(got_p.numpy(), want_p, "d pos")
    _assert_close(got_m.numpy(), want_m, "d mask")


def test_springs_vjp_at_forty_slots():
    """40 slots a cell, more than one word of kernel E''s occupancy mask:
    the closed form against ``jax.vjp`` of the oracle, with coincident
    pairs in a cell's second word (eager oracle: one more shape)."""
    kc, shape = 40, (3, 4, 3)
    cfg = SimConfig(grid_size=shape, cell_size=H, particle_capacity=64)
    tcfg = convert.config_from_fields(**vars(cfg))
    rng = np.random.default_rng(40)
    counts = rng.integers(0, kc + 1, size=shape)
    counts[1, 2, 1] = kc
    mask = (np.arange(kc)[:, None, None, None] < counts[None]).astype(np.float32)
    cell = np.stack(np.meshgrid(*(np.arange(n) for n in shape), indexing="ij"))
    pos = (cell[:, None] + rng.uniform(0.05, 0.95, (3, kc) + shape)) * H
    pos[:, 35, 1, 2, 1] = pos[:, 3, 1, 2, 1]
    pos = (pos * mask[None]).astype(np.float32)
    g = rng.normal(size=pos.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda p, m: correction._springs_jnp(p, m, RE2, jnp.int32(SEED), cfg),
                     jnp.asarray(pos), jnp.asarray(mask))
    want_p, want_m = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    got_p, got_m = t_correction._springs_vjp_torch(
        torch.from_numpy(pos), torch.from_numpy(mask), torch.from_numpy(g), RE2, SEED, tcfg)
    _assert_close(got_p.numpy(), want_p, "d pos")
    _assert_close(got_m.numpy(), want_m, "d mask")
