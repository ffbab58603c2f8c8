"""The port's path-tracer loops (``libfluid_tpu_torch.renderer.pathtrace``)
against the JAX package's with the JAX package's own random numbers
injected (``tests/jax_draws.py``): ``trace_rays`` in both forms,
``_trace_persistent_brute`` and ``_trace_persistent_mega``. Whole loops
are held to: at least 99 % of the samples within 1e-4 relative (a path
that a rounding sends another way differs entirely), the image mean within
1e-3 relative, and the rays cast within 1 %."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_draws import JaxDraws, JaxStream
from libfluid_tpu.config import RenderConfig
from libfluid_tpu.renderer import accel, pathtrace, scenes
from libfluid_tpu.renderer.scene import SceneBuilder
from libfluid_tpu_torch.config import RenderConfig as TRenderConfig
from libfluid_tpu_torch.renderer import accel as t_accel
from libfluid_tpu_torch.renderer import draws, loops, render
from libfluid_tpu_torch.renderer import pathtrace as t_pathtrace
from libfluid_tpu_torch.renderer import scenes as t_scenes
from libfluid_tpu_torch.renderer.scene import SceneBuilder as TSceneBuilder

torch.set_num_threads(1)


def _cfgs(**kw):
    return RenderConfig(**kw), TRenderConfig(**kw)


def _assert_tracer_close(got, want, cast=None, want_cast=None):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    near = np.abs(got - want) <= 1e-4 * np.abs(want) + 1e-6
    assert near.mean() >= 0.99, near.mean()
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-3)
    if cast is not None:
        np.testing.assert_allclose(int(cast), int(want_cast), rtol=0.01)


def _scene(name):
    mk = {"cornell": "cornell_box_one_light", "glass": "glass_ball_box"}[name]
    b, cam = getattr(scenes, mk)(1.0)
    tb, tcam = getattr(t_scenes, mk)(1.0, device="cpu")
    return b.finish(), cam, tb.finish(device="cpu"), tcam


def _camera_rays(cam, tcam, n=24):
    sp = np.random.default_rng(0).uniform(size=(n * n, 2)).astype(np.float32)
    o, d = cam.get_rays(jnp.asarray(sp))
    to, td = tcam.get_rays(torch.from_numpy(sp))
    return (o, d), (to, td)


@pytest.mark.parametrize("differentiable", [True, False], ids=["fixed-count", "early-exit"])
@pytest.mark.parametrize("name", ["cornell", "glass"])
def test_trace_rays_matches_jax(name, differentiable):
    scene, cam, t_scene, tcam = _scene(name)
    cfg, tcfg = _cfgs(max_bounces=5, differentiable=differentiable)
    (o, d), (to, td) = _camera_rays(cam, tcam)
    key = jax.random.PRNGKey(3)
    want, want_cast = pathtrace.trace_rays(scene, o, d, key, cfg, with_stats=True)
    loops.reset_host_reads()
    got, cast = t_pathtrace.trace_rays(t_scene, to, td, JaxStream(key, cfg.max_bounces), tcfg, with_stats=True)
    assert loops.HOST_READS["count"] == (0 if differentiable else pytest.approx(5, abs=5))
    _assert_tracer_close(got, want, cast, want_cast)


def test_trace_rays_default_draws_are_a_pure_function():
    """A torch.Generator keys the counter-based draws: the same seed gives
    the same radiance, the early-exit form the fixed-count one's."""
    _, _, t_scene, tcam = _scene("cornell")
    o, d = tcam.get_rays(torch.rand((300, 2), generator=torch.Generator().manual_seed(0)))
    runs = [t_pathtrace.trace_rays(t_scene, o, d, torch.Generator().manual_seed(9),
                                   TRenderConfig(differentiable=diff), with_stats=True)
            for diff in (True, False, True)]
    assert torch.equal(runs[0][0], runs[2][0])
    assert torch.equal(runs[0][0], runs[1][0]) and int(runs[0][1]) == int(runs[1][1])
    other = t_pathtrace.trace_rays(t_scene, o, d, torch.Generator().manual_seed(10), TRenderConfig())
    assert not torch.equal(other, runs[0][0])


@pytest.mark.parametrize("name", ["cornell", "glass"])
def test_persistent_brute_matches_jax(name):
    scene, cam, t_scene, tcam = _scene(name)
    cfg, tcfg = _cfgs(width=16, height=12, samples_per_pixel=3, max_bounces=5, differentiable=False)
    key = jax.random.PRNGKey(5)
    want, want_cast = pathtrace._trace_persistent_brute(scene, cam, cfg, key, True)
    loops.reset_host_reads()
    got, cast = t_pathtrace.trace_persistent(t_scene, tcam, tcfg, JaxDraws(key, cfg), True)
    assert loops.HOST_READS["count"] > 0
    _assert_tracer_close(got.numpy(), want, cast, want_cast)


def _fluid_like(cls):
    """A room (big triangles) around a bumpy sheet of small ones."""
    b, _ = (scenes if cls is SceneBuilder else t_scenes).fluid_box(
        (0.0, 0.0, 0.0), (8.0, 8.0, 8.0), **({} if cls is SceneBuilder else {"device": "cpu"}))
    water = b.lambertian((0.4, 0.55, 0.8))
    x, z = np.meshgrid(np.linspace(0.5, 7.5, 15), np.linspace(0.5, 7.5, 15), indexing="ij")
    y = 3.0 + 0.6 * np.sin(x) * np.cos(z)
    p = np.stack([x, y, z], -1)
    quads = np.stack([p[:-1, :-1], p[1:, :-1], p[1:, 1:], p[:-1, 1:]], 2).reshape(-1, 4, 3)
    tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
    b.add_triangle_soup(tris, water)
    return b


def test_persistent_mega_matches_jax_and_brute():
    b, cam = scenes.fluid_box((0.0, 0.0, 0.0), (8.0, 8.0, 8.0))
    _, tcam = t_scenes.fluid_box((0.0, 0.0, 0.0), (8.0, 8.0, 8.0), device="cpu")
    scene, t_scene = _fluid_like(SceneBuilder).finish(), _fluid_like(TSceneBuilder).finish(device="cpu")
    scene = scene._replace(accel=accel.build(scene, res=(14, 14, 14)))
    t_scene = t_scene._replace(accel=t_accel.build(t_scene, res=(14, 14, 14), device="cpu"))
    assert int(t_scene.accel.big_overflow) == 0
    cfg, tcfg = _cfgs(width=12, height=12, samples_per_pixel=3, max_bounces=4, differentiable=False)
    key = jax.random.PRNGKey(6)
    want, want_cast = pathtrace._trace_persistent_mega(scene, cam, cfg, key, True)
    got, cast = t_pathtrace.trace_persistent(t_scene, tcam, tcfg, JaxDraws(key, cfg), True)
    assert got.mean() > 0
    _assert_tracer_close(got.numpy(), want, cast, want_cast)
    # the same estimator without the accelerator: the brute tracer, same draws
    brute, brute_cast = t_pathtrace.trace_persistent(t_scene._replace(accel=None), tcam, tcfg,
                                                     JaxDraws(key, cfg), True)
    _assert_tracer_close(got.numpy(), brute.numpy(), cast, brute_cast)


def test_hash_draws_are_uniform_and_keyed():
    d = draws.HashDraws.from_generator(torch.Generator().manual_seed(1))
    u = d.lane(torch.arange(100_000), torch.zeros(100_000, dtype=torch.int64), 3)
    assert u.shape == (100_000, 3) and float(u.min()) >= 0.0 and float(u.max()) < 1.0
    np.testing.assert_allclose(u.mean(0).numpy(), 0.5, atol=5e-3)
    np.testing.assert_allclose(np.corrcoef(u.T.numpy()), np.eye(3), atol=1e-2)
    again = draws.HashDraws(d.seed).lane(torch.arange(100_000), torch.zeros(100_000, dtype=torch.int64), 3)
    assert torch.equal(u, again)
    xi, r = d.stream(0, 0).bounce(1, 1000, "cpu")
    assert xi.shape == (1000, 2) and r.shape == (1000,)
    assert not torch.equal(d.jitter(0, 10, "cpu"), d.jitter(1, 10, "cpu"))


def test_render_does_not_depend_on_the_strip_size():
    """The default draws are keyed by a ray's index in its sample, so the
    fixed-count tracer gives the same image in strips of any size (the last
    strip padded or not)."""
    _, _, t_scene, tcam = _scene("cornell")
    imgs = [render(t_scene, tcam, TRenderConfig(width=12, height=10, samples_per_pixel=2, max_bounces=3,
                                                ray_batch=rb), torch.Generator().manual_seed(4), device="cpu")
            for rb in (120, 32, 7)]
    assert float(imgs[0].mean()) > 0
    for img in imgs[1:]:
        _assert_tracer_close(img.numpy(), imgs[0].numpy())
