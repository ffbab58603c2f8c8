"""The port's math substrate and PPM writer (``libfluid_tpu_torch.math``,
``libfluid_tpu_torch.io.ppm``) against the JAX package's on the same
numpy-seeded inputs: the cases of ``tests/test_math.py``, each function
held to its JAX counterpart (rtol 1e-6 on values, exact on masks), and
the PPM bytes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu.io.ppm import save_ppm
from libfluid_tpu.math import interp, intersection, transforms, warping
from libfluid_tpu_torch.io.ppm import save_ppm as t_save_ppm
from libfluid_tpu_torch.math import interp as t_interp
from libfluid_tpu_torch.math import intersection as t_intersection
from libfluid_tpu_torch.math import transforms as t_transforms
from libfluid_tpu_torch.math import warping as t_warping

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, rtol=1e-6, atol=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_trilerp_corners_match_jax():
    vals = np.arange(8.0, dtype=np.float32)
    rng = np.random.default_rng(0)
    t = rng.uniform(0, 1, (3, 50)).astype(np.float32)
    want = interp.trilerp(*(jnp.asarray(v) for v in vals), *(jnp.asarray(x) for x in t))
    got = t_interp.trilerp(*(torch.tensor(v) for v in vals), *(_t(x) for x in t))
    _close(got, want)
    assert float(t_interp.trilerp(*vals, 0.0, 0.0, 0.0)) == vals[0]
    assert float(t_interp.trilerp(*vals, 1.0, 1.0, 1.0)) == vals[7]


def test_hat_and_grad_hat_match_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
    _close(t_interp.hat(_t(x)), interp.hat(jnp.asarray(x)))
    _close(t_interp.grad_hat(_t(x), 2.0), interp.grad_hat(jnp.asarray(x), 2.0))
    frac = rng.uniform(0, 1, (32, 3)).astype(np.float32)
    total = sum(t_interp.hat(_t(frac) - torch.tensor([dx, dy, dz], dtype=torch.float32))
                for dx in (0, 1) for dy in (0, 1) for dz in (0, 1))
    np.testing.assert_allclose(total.numpy(), 1.0, atol=1e-5)


def test_ray_triangle_matches_jax():
    rng = np.random.default_rng(2)
    o = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    p0, e1, e2 = (rng.uniform(-1, 1, (200, 3)).astype(np.float32) for _ in range(3))
    # aimed at a point near each triangle's centre: about half hit
    d = (p0 + 0.33 * (e1 + e2) + rng.normal(scale=0.4, size=(200, 3)) - o).astype(np.float32)
    want = intersection.ray_triangle(*(jnp.asarray(a) for a in (o, d, p0, e1, e2)))
    got = t_intersection.ray_triangle(*(_t(a) for a in (o, d, p0, e1, e2)))
    assert want[0].any() and not want[0].all()
    _close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, rtol=1e-5, atol=1e-5)
    hit, t, u, v = t_intersection.ray_triangle(
        _t([0.25, 0.25, 1.0]), _t([0.0, 0.0, -1.0]), _t([0, 0, 0]), _t([1, 0, 0]), _t([0, 1, 0]))
    assert bool(hit) and abs(float(t) - 1.0) < 1e-6 and abs(float(u) - 0.25) < 1e-6


def test_ray_aabb_matches_jax():
    rng = np.random.default_rng(3)
    o = rng.uniform(-3, 3, (300, 3)).astype(np.float32)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32)
    want = intersection.ray_aabb(jnp.asarray(o), 1.0 / jnp.asarray(d), jnp.asarray(lo), jnp.asarray(hi))
    got = t_intersection.ray_aabb(_t(o), 1.0 / _t(d), _t(lo), _t(hi))
    assert want[0].any() and not want[0].all()
    _close(got[0], want[0])
    _close(got[1], want[1], rtol=1e-6, atol=1e-6)


def test_ray_unit_sphere_matches_jax():
    rng = np.random.default_rng(4)
    o = rng.uniform(-3, 3, (300, 3)).astype(np.float32)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    want = intersection.ray_unit_sphere(jnp.asarray(o), jnp.asarray(d))
    got = t_intersection.ray_unit_sphere(_t(o), _t(d))
    assert want[0].any() and not want[0].all()
    _close(got[0], want[0])
    _close(got[1], want[1], rtol=1e-5, atol=1e-6)
    hit, t = t_intersection.ray_unit_sphere(torch.zeros(3), _t([0.0, 0.0, 1.0]))
    assert bool(hit) and abs(float(t) - 1.0) < 1e-6  # from inside: the far root


def test_ray_unit_sphere_gradient_finite_at_a_tangent():
    """A ray that grazes the sphere (discriminant exactly 0) hits it, with
    the JAX package's t, and its gradient is finite; JAX's is NaN there
    (sqrt'(0) times a zero cotangent), so the port's takes the tangent's
    square root as a constant 0."""
    o = torch.tensor([[0.0, 1.0, -5.0], [0.3, 0.2, -5.0]], requires_grad=True)
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], requires_grad=True)
    hit, t = t_intersection.ray_unit_sphere(o, d)
    want_hit, want_t = intersection.ray_unit_sphere(jnp.asarray(o.detach().numpy()), jnp.asarray(d.detach().numpy()))
    assert hit.tolist() == [True, True] == np.asarray(want_hit).tolist()
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(want_t), rtol=1e-6)
    # the unchosen sphere's zero cotangent: a tangent hit under a where
    torch.where(torch.tensor([False, True]), t, torch.zeros_like(t)).sum().backward()
    assert torch.isfinite(o.grad).all() and torch.isfinite(d.grad).all()
    assert float(o.grad[1].abs().sum()) > 0


def test_aabb_triangle_matches_jax():
    rng = np.random.default_rng(5)
    c = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    h = np.full((400, 3), 0.5, np.float32)
    p0, p1, p2 = (rng.uniform(-2, 2, (400, 3)).astype(np.float32) for _ in range(3))
    want = intersection.aabb_triangle(*(jnp.asarray(a) for a in (c, h, p0, p1, p2)))
    got = t_intersection.aabb_triangle(*(_t(a) for a in (c, h, p0, p1, p2)))
    assert want.any() and not want.all()
    _close(got, want)
    # a large triangle slicing the box without a vertex inside
    assert bool(t_intersection.aabb_triangle(torch.zeros(3), torch.full((3,), 0.5), _t([-5, -5, 0.1]),
                                             _t([5, -5, 0.1]), _t([0, 10, 0.1])))


@pytest.mark.parametrize("name", [
    "unit_disk_from_unit_square", "unit_disk_from_unit_square_concentric",
    "unit_sphere_from_unit_square", "unit_hemisphere_from_unit_square",
    "unit_hemisphere_cosine_from_unit_square",
])
def test_warping_matches_jax(name):
    xi = np.array(jax.random.uniform(jax.random.PRNGKey(0), (20000, 2)))
    xi[:3] = [[0.5, 0.5], [0.0, 0.0], [0.999, 0.25]]  # the concentric map's centre, a corner
    want = getattr(warping, name)(jnp.asarray(xi))
    got = getattr(t_warping, name)(_t(xi))
    _close(got, want, rtol=1e-5, atol=2e-6)
    if name == "unit_hemisphere_cosine_from_unit_square":
        # cosine-weighted: E[cos theta] = 2/3
        np.testing.assert_allclose(got[..., 2].mean().item(), 2.0 / 3.0, atol=0.01)
        _close(t_warping.pdf_unit_hemisphere_cosine(got), warping.pdf_unit_hemisphere_cosine(want),
               rtol=1e-5, atol=1e-6)


def test_transforms_match_jax():
    """Rotations about one axis (those of the canned scenes) carry JAX's
    float32 bits; about three axes the 3 x 3 products round differently
    (rtol 1e-6)."""
    s, e, t = np.array([1.5, 2.0, 0.5]), np.array([0.3, -0.2, 1.1]), np.array([1.0, 2.0, 3.0])
    want = np.asarray(transforms.scale_rotate_translate(s, e, t))
    got = t_transforms.scale_rotate_translate(s, e, t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    for angles in ([np.pi, 0, 0], [0, 0, -0.5 * np.pi], [0, 27.5 * np.pi / 180, 0], [0.5 * np.pi, 0, 0]):
        np.testing.assert_array_equal(t_transforms.scale_rotate_translate(s, angles, t).numpy(),
                                      np.asarray(transforms.scale_rotate_translate(s, np.array(angles), t)))
    np.testing.assert_array_equal(t_transforms.scale(s).numpy(), np.asarray(transforms.scale(s)))
    m = t_transforms.scale_rotate_translate(s, e, t)
    p = _t(np.random.default_rng(1).normal(size=(10, 3)))
    back = t_transforms.apply_point(t_transforms.inverse(m), t_transforms.apply_point(m, p))
    np.testing.assert_allclose(back.numpy(), p.numpy(), atol=1e-5)
    _close(t_transforms.apply_vector(m, p), transforms.apply_vector(jnp.asarray(m.numpy()),
                                                                    jnp.asarray(p.numpy())), rtol=1e-6)


@pytest.mark.parametrize("gamma", [None, 2.2])
def test_ppm_bytes_equal_jax(tmp_path, gamma):
    img = np.random.default_rng(6).uniform(-0.2, 1.4, (7, 5, 3)).astype(np.float32)
    save_ppm(tmp_path / "jax.ppm", jnp.asarray(img), gamma=gamma)
    t_save_ppm(tmp_path / "port.ppm", torch.from_numpy(img), gamma=gamma)
    want = (tmp_path / "jax.ppm").read_bytes()
    assert want.startswith(b"P6\n5 7\n255\n")
    assert (tmp_path / "port.ppm").read_bytes() == want
