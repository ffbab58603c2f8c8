"""The port's materials (``libfluid_tpu_torch.renderer.materials``) against
the JAX package's on the same numpy-seeded inputs: ``sample_bsdf``,
``eval_bsdf``, ``pdf_bsdf`` and ``fresnel_dielectric`` with the same `xi`
(1e-6), ``sample_texture`` and the cases of ``tests/test_textures.py``
(the textured render with the JAX package's draws injected)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_draws import JaxDraws
from libfluid_tpu.config import RenderConfig
from libfluid_tpu.renderer import materials, scenes
from libfluid_tpu_torch.config import RenderConfig as TRenderConfig
from libfluid_tpu_torch.renderer import materials as t_materials
from libfluid_tpu_torch.renderer import scenes as t_scenes

render = importlib.import_module("libfluid_tpu.renderer.render").render
t_render = importlib.import_module("libfluid_tpu_torch.renderer.render").render

torch.set_num_threads(1)
TOL = 1e-6


def _table(textured: bool):
    """Lambertian, mirror, glass (IOR 1.5 and 1.0), an emitter; with
    `textured` the lambertian's albedo through a 3 x 4 texture."""
    tex = np.random.default_rng(3).uniform(0.2, 0.9, (3, 4, 3))
    table = []
    for mod in (materials, t_materials):
        asarray = jnp.asarray if mod is materials else torch.tensor
        i64 = jnp.int32 if mod is materials else torch.int64
        f32 = jnp.float32 if mod is materials else torch.float32
        textures = np.stack([np.ones((3, 4, 3)), tex]) if textured else np.ones((1, 1, 1, 3))
        table.append(mod.MaterialTable(
            kind=asarray([0, 0, 1, 2, 2, 0], dtype=i64),
            albedo=asarray([[0, 0, 0], [0.6, 0.5, 0.4], [0.9, 0.9, 0.9], [1, 1, 1], [0.8, 1, 1],
                            [0.2, 0.2, 0.2]], dtype=f32),
            ior=asarray([1.0, 1.0, 1.0, 1.5, 1.0, 1.0], dtype=f32),
            emission=asarray([[0, 0, 0]] * 5 + [[3.0, 2.0, 1.0]], dtype=f32),
            albedo_tex=asarray([0, 1 if textured else 0, 0, 0, 0, 0], dtype=i64),
            emission_tex=asarray([0] * 6, dtype=i64),
            textures=asarray(textures, dtype=f32),
            tex_hw=asarray([[3, 4], [3, 4]] if textured else [[1, 1]], dtype=i64),
        ))
    return table


def _inputs(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, 6, n)
    w = rng.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    w[:20, 1] = 0.0  # grazing
    wout = rng.normal(size=(n, 3))
    wout /= np.linalg.norm(wout, axis=-1, keepdims=True)
    xi = rng.uniform(size=(n, 2))
    uv = rng.uniform(-1.5, 2.5, (n, 2))
    return mat, w.astype(np.float32), wout.astype(np.float32), xi.astype(np.float32), uv.astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("textured", [False, True], ids=["plain", "textured"])
@pytest.mark.parametrize("mode", [materials.RADIANCE, materials.IMPORTANCE], ids=["radiance", "importance"])
def test_sample_bsdf_matches_jax(textured, mode):
    jt, tt = _table(textured)
    mat, win, _, xi, uv = _inputs()
    want = materials.sample_bsdf(jt, jnp.asarray(mat, jnp.int32), jnp.asarray(win), jnp.asarray(xi), mode,
                                 uv=jnp.asarray(uv))
    got = t_materials.sample_bsdf(tt, torch.from_numpy(mat), torch.from_numpy(win), torch.from_numpy(xi),
                                  mode, uv=torch.from_numpy(uv))
    _close(got.direction, want.direction)
    _close(got.pdf, want.pdf)
    _close(got.reflectance, want.reflectance, 1e-5)  # 1 / cos at grazing angles
    np.testing.assert_array_equal(got.is_delta.numpy(), np.asarray(want.is_delta))
    # the glass draws both branches and total internal reflection
    glass = mat == 3
    assert 0 < (np.asarray(want.direction)[glass, 1] * win[glass, 1] < 0).sum() < glass.sum()


@pytest.mark.parametrize("textured", [False, True], ids=["plain", "textured"])
def test_eval_and_pdf_bsdf_match_jax(textured):
    jt, tt = _table(textured)
    mat, win, wout, _, uv = _inputs(seed=1)
    jm, tm = jnp.asarray(mat, jnp.int32), torch.from_numpy(mat)
    _close(t_materials.eval_bsdf(tt, tm, torch.from_numpy(win), torch.from_numpy(wout), torch.from_numpy(uv)),
           materials.eval_bsdf(jt, jm, jnp.asarray(win), jnp.asarray(wout), jnp.asarray(uv)))
    _close(t_materials.pdf_bsdf(tt, tm, torch.from_numpy(win), torch.from_numpy(wout)),
           materials.pdf_bsdf(jt, jm, jnp.asarray(win), jnp.asarray(wout)))
    np.testing.assert_array_equal(t_materials.is_delta_kind(tt, tm).numpy(),
                                  np.asarray(materials.is_delta_kind(jt, jm)))
    _close(t_materials.emission_at(tt, tm, torch.from_numpy(uv)),
           materials.emission_at(jt, jm, jnp.asarray(uv)))
    _close(t_materials.albedo_at(tt, tm, torch.from_numpy(uv)), materials.albedo_at(jt, jm, jnp.asarray(uv)))


def test_fresnel_matches_jax():
    rng = np.random.default_rng(2)
    ci, co = (rng.uniform(0.01, 1, 500).astype(np.float32) for _ in range(2))
    ei, eo = (rng.uniform(1, 2, 500).astype(np.float32) for _ in range(2))
    _close(t_materials.fresnel_dielectric(*(torch.from_numpy(a) for a in (ci, co, ei, eo))),
           materials.fresnel_dielectric(*(jnp.asarray(a) for a in (ci, co, ei, eo))))


def _single_texture_table(tex):
    textures = torch.stack([torch.ones_like(tex), tex])  # id 0 = white
    hw = torch.tensor([[tex.shape[0], tex.shape[1]]] * 2)
    return textures, hw


def test_bilinear_center_and_corners():
    tex = np.zeros((2, 2, 3), np.float32)
    tex[0, 0] = (1, 0, 0)
    tex[0, 1] = (0, 1, 0)
    tex[1, 0] = (0, 0, 1)
    tex[1, 1] = (1, 1, 1)
    textures, hw = _single_texture_table(torch.from_numpy(tex))
    uv = torch.tensor([[0.25, 0.25], [0.75, 0.25], [0.5, 0.5], [0.0, 0.0]])
    out = t_materials.sample_texture(textures, hw, torch.ones(4, dtype=torch.int64), uv).numpy()
    np.testing.assert_allclose(out[0], tex[0, 0], atol=1e-6)
    np.testing.assert_allclose(out[1], tex[0, 1], atol=1e-6)
    np.testing.assert_allclose(out[2], tex.mean((0, 1)), atol=1e-6)
    np.testing.assert_allclose(out[3], tex[0, 0], atol=1e-6)


def test_wrap_semantics_and_sample_texture_match_jax():
    tex = np.random.RandomState(0).uniform(size=(4, 5, 3)).astype(np.float32)
    textures, hw = _single_texture_table(torch.from_numpy(tex))
    uv = np.asarray([[0.3, 0.6], [1.3, -0.4], [-1.7, 2.6]], np.float32)
    out = t_materials.sample_texture(textures, hw, torch.ones(3, dtype=torch.int64), torch.from_numpy(uv))
    np.testing.assert_allclose(out[1].numpy(), out[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(out[2].numpy(), out[0].numpy(), atol=1e-6)
    rng = np.random.default_rng(4)
    uv = rng.uniform(-3, 3, (500, 2)).astype(np.float32)
    tid = rng.integers(0, 2, 500)
    want = materials.sample_texture(jnp.asarray(textures.numpy()), jnp.asarray(hw.numpy(), jnp.int32),
                                    jnp.asarray(tid, jnp.int32), jnp.asarray(uv))
    _close(t_materials.sample_texture(textures, hw, torch.from_numpy(tid), torch.from_numpy(uv)), want, 1e-5)


def test_textured_render_differs_and_matches_jax():
    """A textured material changes the image, and the port's render of the
    textured Cornell box with the JAX package's draws matches JAX's (the
    rule of whole loops: 99 % of the pixels within 1e-4 relative, the mean
    within 1e-3)."""
    tex = np.random.RandomState(1).uniform(0.2, 0.9, (4, 4, 3))
    cfg = RenderConfig(width=16, height=16, samples_per_pixel=2, max_bounces=3, ray_batch=256)
    tcfg = TRenderConfig(width=16, height=16, samples_per_pixel=2, max_bounces=3, ray_batch=256)
    key = jax.random.PRNGKey(0)
    imgs = {}
    for textured in (False, True):
        b, cam = scenes.cornell_box_one_light(1.0)
        tb, tcam = t_scenes.cornell_box_one_light(1.0, device="cpu")
        tid, t_tid = b.add_texture(tex), tb.add_texture(tex)
        scene, t_scene = b.finish(), tb.finish(device="cpu")
        if textured:
            scene = scene._replace(materials=scene.materials._replace(
                albedo_tex=scene.materials.albedo_tex.at[1].set(tid)))
            atex = t_scene.materials.albedo_tex.clone()
            atex[1] = t_tid
            t_scene = t_scene._replace(materials=t_scene.materials._replace(albedo_tex=atex))
        want = np.asarray(render(scene, cam, cfg, key))
        got = t_render(t_scene, tcam, tcfg, JaxDraws(key, cfg), device="cpu").numpy()
        assert np.isfinite(got).all()
        near = np.abs(got - want) <= 1e-4 * np.abs(want) + 1e-6
        assert near.mean() >= 0.99, near.mean()
        np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-3)
        imgs[textured] = got
    assert np.max(np.abs(imgs[True] - imgs[False])) > 1e-3
