"""The port's uniform-grid accelerator (``libfluid_tpu_torch.renderer.accel``)
against the JAX package's: ``build``'s CSR (``cell_start``, ``tri_ids``),
``big_ids``, ``big_overflow`` and the proximity field ``dist`` equal JAX's
exactly; ``traverse`` against JAX's and against the port's brute force
(the same hits and triangles, t within rtol 1e-5); and the six cases of
``tests/test_accel.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu.renderer import accel, intersect, scenes
from libfluid_tpu.renderer.scene import SceneBuilder
from libfluid_tpu_torch.renderer import accel as t_accel
from libfluid_tpu_torch.renderer import intersect as t_intersect
from libfluid_tpu_torch.renderer import loops
from libfluid_tpu_torch.renderer import scenes as t_scenes
from libfluid_tpu_torch.renderer.scene import SceneBuilder as TSceneBuilder

torch.set_num_threads(1)


def _both(make):
    """(JAX scene, port scene) of one builder recipe."""
    return make(SceneBuilder).finish(), make(TSceneBuilder).finish(device="cpu")


def _soup(cls, n=400, seed=7, size=0.08):
    rng = np.random.RandomState(seed)
    base = rng.uniform(-1.0, 1.0, (n, 1, 3))
    b = cls()
    b.add_triangle_soup(base + rng.uniform(-size, size, (n, 3, 3)), b.lambertian((0.5, 0.5, 0.5)))
    return b


def _mixed(cls):
    rng = np.random.RandomState(3)
    b = cls()
    m = b.lambertian((0.5, 0.5, 0.5))
    floor = np.array([[[-5, -1, -5], [5, -1, -5], [5, -1, 5]], [[-5, -1, -5], [5, -1, 5], [-5, -1, 5]]], float)
    b.add_triangle_soup(floor, m)
    b.add_triangle_soup(rng.uniform(-1, 1, (200, 1, 3)) + rng.uniform(-0.05, 0.05, (200, 3, 3)), m)
    t = np.zeros((3, 4))
    t[:, :3] = np.eye(3) * 0.3
    t[:, 3] = (0.2, 0.1, -0.2)
    b.add_sphere(t, m)
    return b


def _fine(cls):
    rng = np.random.default_rng(4)
    b = cls()
    ctr = rng.uniform(1.5, 6.5, (80, 3))
    verts = np.concatenate([c + rng.normal(0, 0.4, (3, 3)) for c in ctr], axis=0)
    b.add_mesh(verts, np.arange(240).reshape(80, 3), b.lambertian((0.5, 0.5, 0.5)))
    return b


def _cornell(cls):
    return (scenes if cls is SceneBuilder else t_scenes).cornell_box_one_light(
        1.0, **({} if cls is SceneBuilder else {"device": "cpu"}))[0]


SCENES = {"cornell": _cornell, "soup": _soup, "mixed": _mixed, "fine": _fine}


def _rays(key, n, lo, hi):
    k1, k2 = jax.random.split(key)
    o = jax.random.uniform(k1, (n, 3), minval=lo, maxval=hi)
    d = jax.random.normal(k2, (n, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return np.asarray(o), np.asarray(d)


def _assert_build_equal(got, want):
    for name in ("cell_start", "tri_ids", "big_ids", "big_overflow", "dist"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(got.lo.numpy(), np.asarray(want.lo))
    np.testing.assert_array_equal(got.cell.numpy(), np.asarray(want.cell))


@pytest.mark.parametrize("name,res,cap", [
    ("cornell", (16, 16, 16), 128), ("cornell", (8, 8, 8), 4), ("soup", (16, 16, 16), 128),
    ("mixed", (16, 16, 16), 128), ("fine", (16, 16, 16), 128), ("fine", (7, 9, 5), 2),
])
def test_build_equals_jax(name, res, cap):
    scene, t_scene = _both(SCENES[name])
    want = accel.build(scene, res=res, big_capacity=cap)
    got = t_accel.build(t_scene, res=res, big_capacity=cap, device="cpu")
    _assert_build_equal(got, want)
    assert int(want.dist.max()) > 1  # the field hops somewhere


def _traverse_both(scene, t_scene, res, o, d):
    acc = accel.build(scene, res=res)
    t_acc = t_accel.build(t_scene, res=res, device="cpu")
    want = accel.traverse(acc, accel.pack_tris(scene), jnp.asarray(o), jnp.asarray(d), jnp.float32(3.0e38))
    got = t_accel.traverse(t_acc, t_accel.pack_tris(t_scene), torch.from_numpy(o), torch.from_numpy(d), 3.0e38)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("name", ["cornell", "soup", "mixed"])
def test_traverse_matches_jax_and_brute_force(name):
    scene, t_scene = _both(SCENES[name])
    o, d = _rays(jax.random.PRNGKey(5), 512, -1.2, 1.2)
    loops.reset_host_reads()
    got, want = _traverse_both(scene, t_scene, (16, 16, 16), o, d)
    assert 0 < loops.HOST_READS["count"] <= (2 * 48 + 64) // loops.TRAVERSE_CHECK_EVERY + 1
    hit = want[1] >= 0
    assert hit.any() and (~hit).any()
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=1e-5)
    np.testing.assert_allclose(got[2][hit], want[2][hit], rtol=1e-5, atol=1e-6)
    brute = t_intersect._brute_force_tris(t_scene, torch.from_numpy(o), torch.from_numpy(d), 3.0e38)
    np.testing.assert_array_equal(got[1] >= 0, brute[1].numpy() >= 0)
    np.testing.assert_allclose(got[0][hit], brute[0].numpy()[hit], rtol=1e-5)


def _assert_same_hits(t_scene, o, d, res=(16, 16, 16)):
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    brute = t_intersect.ray_cast(t_scene, o, d)
    acc = t_scene._replace(accel=t_accel.build(t_scene, res=res, device="cpu"))
    fast = t_intersect.ray_cast(acc, o, d)
    h = brute.hit.numpy()
    np.testing.assert_array_equal(fast.hit.numpy(), h)
    np.testing.assert_allclose(fast.t.numpy()[h], brute.t.numpy()[h], rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(fast.mat_id.numpy()[h], brute.mat_id.numpy()[h])
    return acc, fast, brute


def test_cornell_box_equivalence():
    _assert_same_hits(_cornell(TSceneBuilder).finish(device="cpu"), *_rays(jax.random.PRNGKey(0), 256, -0.4, 0.4))


def test_random_soup_equivalence():
    _assert_same_hits(_soup(TSceneBuilder).finish(device="cpu"), *_rays(jax.random.PRNGKey(1), 512, -1.2, 1.2))


def test_mixed_scales_and_spheres():
    _assert_same_hits(_mixed(TSceneBuilder).finish(device="cpu"), *_rays(jax.random.PRNGKey(2), 512, -1.5, 1.5))


def test_big_overflow_counts():
    t_scene = _cornell(TSceneBuilder).finish(device="cpu")
    assert int(t_accel.build(t_scene, res=(8, 8, 8), big_capacity=4, device="cpu").big_overflow) > 0
    assert int(t_accel.build(t_scene, res=(8, 8, 8), device="cpu").big_overflow) == 0


def test_build_and_traverse_in_one_call():
    """A fresh mesh re-accelerates and casts in one go (the JAX package's
    jit case): build inside the cast."""
    rng = np.random.RandomState(11)
    b = TSceneBuilder()
    b.add_triangle_soup(rng.uniform(-1, 1, (64, 1, 3)) + rng.uniform(-0.1, 0.1, (64, 3, 3)),
                        b.lambertian((0.5, 0.5, 0.5)))
    t_scene = b.finish(device="cpu")

    def cast(scene, o, d):
        return t_intersect.ray_cast(scene._replace(accel=t_accel.build(scene, res=(16, 16, 16), device="cpu")),
                                    o, d)

    o, d = (torch.from_numpy(a) for a in _rays(jax.random.PRNGKey(4), 128, -1.2, 1.2))
    np.testing.assert_array_equal(cast(t_scene, o, d).hit.numpy(), t_intersect.ray_cast(t_scene, o, d).hit.numpy())


def test_fine_grid_still_exact():
    """Cells up to max_span (2x) finer than the triangles stay exact, with
    nothing dropped past the big list's capacity."""
    t_scene = _fine(TSceneBuilder).finish(device="cpu")
    rng = np.random.default_rng(4)
    o = rng.uniform(0, 8, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    acc, fast, brute = _assert_same_hits(t_scene, o, d)
    assert int(acc.accel.big_overflow) == 0
    np.testing.assert_array_equal(fast.prim_id.numpy(), brute.prim_id.numpy())
