"""The port's scenes (``libfluid_tpu_torch.renderer.scene``, ``scenes``,
``camera``) against the JAX package's: the arrays ``SceneBuilder.finish``
makes for the four canned scenes and the fluid box equal JAX's exactly,
``inject_mesh`` and the camera's rays within rtol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu.renderer import scenes
from libfluid_tpu.renderer.camera import Camera
from libfluid_tpu.renderer.scene import SceneBuilder, inject_mesh
from libfluid_tpu_torch.renderer import scenes as t_scenes
from libfluid_tpu_torch.renderer.camera import Camera as TCamera
from libfluid_tpu_torch.renderer.scene import SceneBuilder as TSceneBuilder
from libfluid_tpu_torch.renderer.scene import inject_mesh as t_inject_mesh

torch.set_num_threads(1)

SCENES = ["red_green_box", "cornell_box_one_light", "cornell_box_two_lights", "glass_ball_box"]
FIELDS = ("tri_p0", "tri_e1", "tri_e2", "tri_normal", "tri_mat", "sph_to_world", "sph_to_local",
          "sph_mat", "light_tri", "light_area", "light_mask")
MAT_FIELDS = ("kind", "albedo", "ior", "emission", "albedo_tex", "emission_tex", "textures", "tex_hw")


def _assert_scene_equal(got, want):
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in MAT_FIELDS:
        np.testing.assert_array_equal(getattr(got.materials, name).numpy(),
                                      np.asarray(getattr(want.materials, name)), err_msg=name)
    assert got.accel is None


def _assert_camera_close(got, want):
    for name in ("position", "norm_forward", "half_horizontal", "half_vertical"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("name", SCENES)
def test_canned_scene_arrays_equal_jax(name):
    b, cam = getattr(scenes, name)(1.0)
    tb, tcam = getattr(t_scenes, name)(1.0, device="cpu")
    _assert_scene_equal(tb.finish(device="cpu"), b.finish())
    _assert_camera_close(tcam, cam)
    # with capacities: the padding rows and light slots
    _assert_scene_equal(tb.finish(tri_capacity=64, light_capacity=4, device="cpu"),
                        b.finish(tri_capacity=64, light_capacity=4))


@pytest.mark.parametrize("aspect", [1.0, 1.5])
def test_fluid_box_arrays_equal_jax(aspect):
    b, cam = scenes.fluid_box((0.0, 0.0, 0.0), (64.0, 64.0, 64.0), aspect=aspect)
    tb, tcam = t_scenes.fluid_box((0.0, 0.0, 0.0), (64.0, 64.0, 64.0), aspect=aspect, device="cpu")
    b.lambertian((0.4, 0.55, 0.8))
    tb.lambertian((0.4, 0.55, 0.8))
    _assert_scene_equal(tb.finish(device="cpu"), b.finish())
    _assert_camera_close(tcam, cam)


def test_textures_spheres_and_soups_equal_jax():
    rng = np.random.default_rng(0)
    tex = rng.uniform(size=(3, 5, 3))
    soup = rng.uniform(-1, 1, (7, 3, 3))
    sph = np.array([[1.0, 0.2, 0, 0.5], [0, 0.8, 0, -1.0], [0.1, 0, 1.2, 2.0]])
    out = []
    for builder in (SceneBuilder(), TSceneBuilder()):
        t = builder.add_texture(tex)
        m = builder.lambertian((0.5, 0.6, 0.7), emission=(1.0, 0.0, 0.0), albedo_tex=t)
        g = builder.glass(1.3, skin=(0.9, 1.0, 1.0))
        builder.mirror()
        builder.add_triangle_soup(soup, m)
        builder.add_sphere(sph, g)
        out.append(builder)
    _assert_scene_equal(out[1].finish(device="cpu"), out[0].finish())


def test_inject_mesh_matches_jax():
    """A soup with invalid rows and degenerate (zero-area) valid rows."""
    b, _ = scenes.cornell_box_one_light(1.0)
    tb, _ = t_scenes.cornell_box_one_light(1.0, device="cpu")
    rng = np.random.default_rng(1)
    verts = rng.uniform(-2, 2, (40, 3, 3)).astype(np.float32)
    verts[5, 2] = verts[5, 0]  # degenerate
    valid = rng.uniform(size=40) < 0.7
    want = inject_mesh(b.finish(), jnp.asarray(verts), jnp.asarray(valid), 3)
    got = t_inject_mesh(tb.finish(device="cpu"), torch.from_numpy(verts), torch.from_numpy(valid), 3)
    for name in FIELDS:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(got.tri_mat.numpy(), np.asarray(want.tri_mat))


def test_camera_rays_match_jax():
    rng = np.random.default_rng(2)
    sp = rng.uniform(size=(500, 2)).astype(np.float32)
    for args in (((1.0, 2.0, -5.0), (0.0, 0.5, 0.0), (0.0, 1.0, 0.0), 0.7, 1.3),
                 ((0.0, 3.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 0.5, 1.0)):  # up || forward
        cam = Camera.from_parameters(*args)
        tcam = TCamera.from_parameters(*args, device="cpu")
        _assert_camera_close(tcam, cam)
        o, d = cam.get_rays(jnp.asarray(sp))
        to, td = tcam.get_rays(torch.from_numpy(sp))
        np.testing.assert_allclose(to.numpy(), np.asarray(o), rtol=1e-6)
        np.testing.assert_allclose(td.numpy(), np.asarray(d), rtol=1e-6, atol=1e-7)
