"""The port's intersection (``libfluid_tpu_torch.renderer.intersect``)
against the JAX package's on Cornell, the glass-sphere scene and a random
soup: ``ray_cast`` and ``finalize_hit`` (the same hits, primitives and
materials; t, positions, normals and uv within rtol 1e-5),
``test_visibility`` (equal) and ``tangent_frame`` (1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu.renderer import intersect, scenes
from libfluid_tpu.renderer.scene import SceneBuilder, unit_box
from libfluid_tpu_torch.renderer import intersect as t_intersect
from libfluid_tpu_torch.renderer import scenes as t_scenes
from libfluid_tpu_torch.renderer.scene import SceneBuilder as TSceneBuilder

torch.set_num_threads(1)


def _soup(builder_cls):
    rng = np.random.RandomState(7)
    base = rng.uniform(-1.0, 1.0, (700, 1, 3))  # more than one chunk of 512
    tris = base + rng.uniform(-0.08, 0.08, (700, 3, 3))
    b = builder_cls()
    m = b.lambertian((0.5, 0.5, 0.5))
    g = b.glass(1.4)
    b.add_triangle_soup(tris[:350], m)
    b.add_triangle_soup(tris[350:], g)
    b.add_sphere(np.array([[0.3, 0, 0, 0.2], [0, 0.3, 0, 0.1], [0, 0, 0.3, -0.2]]), g)
    return b


def _scenes(name):
    if name == "soup":
        return _soup(SceneBuilder).finish(), _soup(TSceneBuilder).finish(device="cpu"), 1.2
    mk = {"cornell": "cornell_box_one_light", "glass": "glass_ball_box"}[name]
    return getattr(scenes, mk)(1.0)[0].finish(), getattr(t_scenes, mk)(1.0, device="cpu")[0].finish(device="cpu"), 4.0


def _rays(n, spread, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    o[:, 1] += 2.0 if spread > 2 else 0.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d


def _assert_hits_close(got, want):
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    assert hit.any() and (~hit).any() or hit.all()
    for name in ("mat_id", "prim_kind", "prim_id"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[hit], np.asarray(getattr(want, name))[hit],
                                      err_msg=name)
    np.testing.assert_array_equal(got.mat_id.numpy(), np.asarray(want.mat_id))
    for name in ("t", "position", "normal", "uv"):
        np.testing.assert_allclose(getattr(got, name).numpy()[hit], np.asarray(getattr(want, name))[hit],
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("name", ["cornell", "glass", "soup"])
def test_ray_cast_matches_jax(name):
    scene, t_scene, spread = _scenes(name)
    o, d = _rays(2000, spread, 0)
    want = intersect.ray_cast(scene, jnp.asarray(o), jnp.asarray(d))
    got = t_intersect.ray_cast(t_scene, torch.from_numpy(o), torch.from_numpy(d))
    _assert_hits_close(got, want)
    if name != "cornell":
        assert (np.asarray(want.prim_kind) == 1).any()  # spheres are hit
    # a finite t_max cuts hits short
    want = intersect.ray_cast(scene, jnp.asarray(o), jnp.asarray(d), t_max=0.5)
    got = t_intersect.ray_cast(t_scene, torch.from_numpy(o), torch.from_numpy(d), t_max=0.5)
    _assert_hits_close(got, want)


@pytest.mark.parametrize("name", ["cornell", "soup"])
def test_finalize_hit_matches_jax(name):
    """finalize_hit on the brute-force triangle search's output, with some
    triangle hits taken away (as a megakernel lane hands over)."""
    scene, t_scene, spread = _scenes(name)
    o, d = _rays(1000, spread, 1)
    tri = intersect._brute_force_tris(scene, jnp.asarray(o), jnp.asarray(d), 3.0e38)
    tri = [np.array(a) for a in tri]
    tri[0][::7], tri[1][::7] = 3.0e38, -1
    want = intersect.finalize_hit(scene, jnp.asarray(o), jnp.asarray(d), *(jnp.asarray(a) for a in tri))
    got = t_intersect.finalize_hit(t_scene, torch.from_numpy(o), torch.from_numpy(d),
                                   *(torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i" else a)
                                     for a in tri))
    _assert_hits_close(got, want)


@pytest.mark.parametrize("name", ["box", "cornell", "glass", "soup"])
def test_visibility_matches_jax(name):
    if name == "box":
        scene_pair = []
        for cls in (SceneBuilder, TSceneBuilder):
            b = cls()
            pos, idx = unit_box()
            b.add_mesh(pos, idx, b.lambertian((0.5, 0.5, 0.5)))
            scene_pair.append(b.finish() if cls is SceneBuilder else b.finish(device="cpu"))
        (scene, t_scene), spread = scene_pair, 2.0
    else:
        scene, t_scene, spread = _scenes(name)
    rng = np.random.default_rng(3)
    p1 = rng.uniform(-spread, spread, (1500, 3)).astype(np.float32)
    p2 = rng.uniform(-spread, spread, (1500, 3)).astype(np.float32)
    if name == "box":
        p1[:2], p2[:2] = [[0, 0, -5], [0, 5, -5]], [[0, 0, 5], [0, 5, 5]]
    want = np.asarray(intersect.test_visibility(scene, jnp.asarray(p1), jnp.asarray(p2)))
    got = t_intersect.test_visibility(t_scene, torch.from_numpy(p1), torch.from_numpy(p2)).numpy()
    assert want.any() and (~want).any()
    np.testing.assert_array_equal(got, want)
    if name == "box":
        assert not got[0] and got[1]  # through the box, above it


def test_tangent_frame_matches_jax():
    rng = np.random.default_rng(4)
    n = rng.normal(size=(500, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[:6] = [[1, 0, 0], [0, 1, 0], [0, 0, -1], [0, 0, 0], [0.6, 0.8, 0], [1, 1, 1]]
    want = np.asarray(intersect.tangent_frame(jnp.asarray(n)))
    got = t_intersect.tangent_frame(torch.from_numpy(n)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
