"""The port's bidirectional path tracer (``libfluid_tpu_torch.renderer.bdpt``)
against the JAX package's on the same scene and the JAX package's own
random numbers (``tests/jax_draws.py``: ``JaxBdptStream`` for
``trace_rays``, ``JaxDraws`` for ``render``): the subpaths, the light
points and the radiance at 8x8 with 3 + 3 bounces in the Cornell box and
the glass ball, radiance within 1e-4 of its largest entry (the subpaths'
tolerances are stated with their test); then the
properties of ``tests/test_bdpt.py`` (subpath masks, the light pdf, a
finite image, the mean of the forward tracer's) on the port's own draws at
sizes a CPU test affords."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu.config import RenderConfig as JaxRenderConfig
from libfluid_tpu.renderer import bdpt as jbdpt
from libfluid_tpu.renderer import scenes as jscenes
from libfluid_tpu.renderer.render import render as jrender
from libfluid_tpu_torch.config import RenderConfig
from libfluid_tpu_torch.renderer import bdpt, draws, scenes

from jax_draws import JaxBdptStream, JaxDraws

render_mod = importlib.import_module("libfluid_tpu_torch.renderer.render")

torch.set_num_threads(1)

_SCENES = {"cornell": (jscenes.cornell_box_one_light, scenes.cornell_box_one_light),
           "glass": (jscenes.glass_ball_box, scenes.glass_ball_box)}
_CFG = dict(width=8, height=8, samples_per_pixel=1, max_camera_bounces=3, max_light_bounces=3)


def _pair(name):
    jmk, tmk = _SCENES[name]
    jb, jcam = jmk(1.0)
    tb, tcam = tmk(1.0, device="cpu")
    return jb.finish(), jcam, tb.finish(device="cpu"), tcam


def _rays(jcam, tcam, n=8):
    rng = np.random.default_rng(0)
    sp = rng.uniform(0.05, 0.95, (n * n, 2)).astype(np.float32)
    jo, jd = jcam.get_rays(jnp.asarray(sp))
    to, td = tcam.get_rays(torch.from_numpy(sp))
    return jo, jd, to, td


def _close(got, want, what, rel=1e-4):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0, atol=rel * scale, err_msg=what)


@pytest.mark.parametrize("name,rel", [("cornell", 1e-4), ("glass", 1e-3)])
def test_subpath_and_light_points_match_jax(name, rel):
    """The camera subpath's fields (within 1e-4 of each field's largest
    entry in the Cornell box; 1e-3 behind the glass ball, whose refractions
    carry float32 rounding into the sphere's normals three bounces on) and
    the s = 1 light points (1e-6)."""
    jscene, jcam, tscene, tcam = _pair(name)
    jo, jd, to, td = _rays(jcam, tcam)
    key = jax.random.PRNGKey(5)
    jcfg = JaxRenderConfig(**_CFG)
    stream = JaxBdptStream(key, jcfg)
    r = to.shape[0]
    jn = jd / jnp.linalg.norm(jd, axis=-1, keepdims=True)
    k_cam = jax.random.split(key, 5)[0]
    want = jbdpt.trace_subpath(jscene, jo, jd, jnp.ones((r, 3)), jnp.ones((r,)), jo, jn, k_cam, 3, 0)
    tn = td / torch.linalg.norm(td, dim=-1, keepdim=True)
    got = bdpt.trace_subpath(tscene, to, td, torch.ones((r, 3)), torch.ones((r,)), to, tn, stream.camera, 3, 0)
    for field in bdpt.Subpath._fields:
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        if g.dtype == torch.bool or field == "mat_id":
            np.testing.assert_array_equal(g.numpy(), w, err_msg=field)
        else:
            _close(g.numpy(), w, field, rel)
    assert bool(got.valid[0].all())

    jl = jbdpt.sample_light_point(jscene, jax.random.split(key, 5)[4], 3 * r)
    tl = bdpt.sample_light_point(tscene, stream, 1, 3, r)
    for field in bdpt.LightSample._fields:
        g, w = getattr(tl, field), np.asarray(getattr(jl, field))
        if g.dtype == torch.bool:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=field)
        else:
            _close(g.numpy(), w, field, 1e-6)


@pytest.mark.parametrize("name", ["cornell", "glass"])
def test_trace_rays_matches_jax(name):
    """Radiance and the cast count of ``trace_rays(with_stats=True)``."""
    jscene, jcam, tscene, tcam = _pair(name)
    jo, jd, to, td = _rays(jcam, tcam)
    key = jax.random.PRNGKey(11)
    jcfg = JaxRenderConfig(**_CFG)
    want, wcast = jbdpt.trace_rays(jscene, jo, jd, key, jcfg, with_stats=True)
    got, cast = bdpt.trace_rays(tscene, to, td, JaxBdptStream(key, jcfg), RenderConfig(**_CFG),
                                with_stats=True)
    want = np.asarray(want)
    assert np.isfinite(want).all() and want.max() > 0
    _close(got.numpy(), want, f"{name} radiance")
    assert int(cast) == int(wcast)


def test_render_bdpt_matches_jax():
    """``render(algorithm="bdpt")`` through the strip loop (two strips of
    32 rays a sample, 2 spp) on the JAX package's key splits."""
    jscene, jcam, tscene, tcam = _pair("cornell")
    kw = dict(_CFG, samples_per_pixel=2, algorithm="bdpt", ray_batch=32)
    key = jax.random.PRNGKey(2)
    want = np.asarray(jrender(jscene, jcam, JaxRenderConfig(**kw), key))
    got = render_mod.render(tscene, tcam, RenderConfig(**kw), JaxDraws(key, JaxRenderConfig(**kw)), device="cpu")
    _close(got.numpy(), want, "image")


def test_subpath_shapes_and_masks():
    """``test_bdpt.test_subpath_shapes_and_masks`` on the port's draws."""
    _, _, scene, cam = _pair("cornell")
    r = 64
    sp = torch.stack([torch.linspace(0.2, 0.8, r), torch.full((r,), 0.5)], dim=-1)
    o, d = cam.get_rays(sp)
    stream = draws.HashDraws(0).bdpt(0, 0)
    sub = bdpt.trace_subpath(scene, o, d, torch.ones((r, 3)), torch.ones((r,)), o,
                             d / torch.linalg.norm(d, dim=-1, keepdim=True), stream.camera, 4, 0)
    assert sub.pos.shape == (4, r, 3)
    assert bool(sub.valid[0].all())
    assert bool((torch.where(sub.valid, sub.pdf_fwd, torch.ones_like(sub.pdf_fwd)) > 0).all())
    np.testing.assert_allclose(sub.beta[0].numpy(), 1.0)


def test_light_sampling_pdf():
    _, _, scene, _ = _pair("cornell")
    ls = bdpt.sample_light_point(scene, draws.HashDraws(1).bdpt(0, 0), 0, 1, 256)
    assert bool(ls.valid.all())
    total = float(torch.sum(torch.where(scene.light_mask, scene.light_area, torch.zeros_like(scene.light_area))))
    np.testing.assert_allclose(ls.pdf_area.numpy(), 1.0 / total, rtol=1e-5)
    assert bool((torch.amax(ls.emission, dim=-1) > 0).all())


def test_bdpt_finite_nonnegative():
    _, _, scene, cam = _pair("cornell")
    cfg = RenderConfig(width=16, height=16, samples_per_pixel=4, algorithm="bdpt", max_camera_bounces=4,
                       max_light_bounces=4, ray_batch=256)
    img = render_mod.render(scene, cam, cfg, torch.Generator().manual_seed(2), device="cpu").numpy()
    assert np.isfinite(img).all() and img.min() >= 0.0 and img.max() > 0.0


@pytest.mark.parametrize("name,spp_pt,spp_bd,rel", [("cornell", 128, 24, 0.08), ("glass", 128, 24, 0.12)])
def test_bdpt_mean_matches_pt(name, spp_pt, spp_bd, rel):
    """Both integrators are unbiased for the same scene: their image means
    agree within the bounds of ``test_bdpt.py`` (8 % Cornell, 12 % glass),
    at 16^2 with 5 bounces."""
    _, _, scene, cam = _pair(name)
    kw = dict(width=16, height=16, max_bounces=5, max_camera_bounces=5, max_light_bounces=5, ray_batch=256)
    pt = render_mod.render(scene, cam, RenderConfig(samples_per_pixel=spp_pt, **kw),
                           torch.Generator().manual_seed(3), device="cpu").numpy()
    bd = render_mod.render(scene, cam, RenderConfig(samples_per_pixel=spp_bd, algorithm="bdpt", **kw),
                           torch.Generator().manual_seed(4), device="cpu").numpy()
    assert np.isfinite(bd).all() and bd.min() >= 0.0
    assert abs(pt.mean() - bd.mean()) / pt.mean() < rel
