"""Parity of the PyTorch port's collision response with the JAX package: the
exact DDA march with obstacles (the fixtures of ``tests/test_collisions.py``
plus a random field of segments through random solids) and the
obstacle-free wall push-out. Positions atol 1e-6."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu.config import SimConfig
from libfluid_tpu.sim import collisions
from libfluid_tpu_torch import convert
from libfluid_tpu_torch.sim import collisions as t_collisions

torch.set_num_threads(1)

CFG = SimConfig(grid_size=(12, 12, 12), cell_size=1.0, particle_capacity=16, has_obstacles=True)


def _solid(cells=(), planes=()):
    s = np.zeros(CFG.grid_size, bool)
    for c in cells:
        s[c] = True
    for axis, i in planes:
        idx = [slice(None)] * 3
        idx[axis] = i
        s[tuple(idx)] = True
    return s


# (solid, old, new) of each test in tests/test_collisions.py
FIXTURES = {
    "straight_hit": (_solid(cells=[(6, 5, 5)]), [[4.5, 5.5, 5.5]], [[7.5, 5.5, 5.5]]),
    "no_hit": (_solid(cells=[(6, 5, 5)]), [[2.5, 2.5, 2.5]], [[3.4, 3.1, 2.9]]),
    "corner_clip": (_solid(cells=[(5, 5, 5)]), [[5.9, 4.5, 5.5]], [[6.1, 5.6, 5.5]]),
    "diagonal_slide": (_solid(planes=[(0, 6)]), [[5.5, 5.5, 5.5]], [[6.5, 7.0, 5.5]]),
    "resting_contact": (_solid(planes=[(1, 0)]), [[5.5, 1.02, 5.5]], [[5.5, 1.02, 5.5]]),
}


def _random_case(seed=0, n=2000):
    """Segments of up to ~3 cells (cfl 3) from random starts through ~15 %
    solid cells; starts and ends may lie in solids and out of the domain."""
    rng = np.random.default_rng(seed)
    solid = rng.uniform(size=CFG.grid_size) < 0.15
    old = rng.uniform(0.0, 12.0, (n, 3))
    new = old + rng.uniform(-3.0, 3.0, (n, 3))
    # axis-aligned and exactly-diagonal moves hit equal t on several axes
    new[: n // 8, 1:] = old[: n // 8, 1:]
    new[n // 8 : n // 4] = old[n // 8 : n // 4] + 1.5
    return solid, old, new


def _both(cfg, solid, old, new):
    old = np.asarray(old, np.float32)
    new = np.asarray(new, np.float32)
    want = np.asarray(collisions.resolve_collisions(
        jnp.asarray(old), jnp.asarray(new), jnp.asarray(solid), cfg))
    tcfg = convert.config_from_fields(**vars(cfg))
    got = t_collisions.resolve_collisions(
        torch.from_numpy(old), torch.from_numpy(new), torch.from_numpy(solid), tcfg
    ).numpy()
    return got, want


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_matches_jax(name):
    got, want = _both(CFG, *FIXTURES[name])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_segments_match_jax(seed):
    solid, old, new = _random_case(seed)
    got, want = _both(CFG, solid, old, new)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got - new).max() > 0.1  # the march did engage


def test_obstacle_free_matches_jax():
    cfg = dataclasses.replace(CFG, has_obstacles=False, grid_offset=(0.5, -1.0, 0.25))
    rng = np.random.default_rng(5)
    new = rng.uniform(-0.5, 12.5, (2000, 3))
    got, want = _both(cfg, np.zeros(cfg.grid_size, bool), new, new)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
