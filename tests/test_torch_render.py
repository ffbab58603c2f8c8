"""The port's render loops (``libfluid_tpu_torch.renderer.render``) on the
cases of ``tests/test_renderer.py`` (furnace, Cornell, mirror, glass of IOR
1, visibility), and against the committed golden images
``tests/golden/{cornell,glass}_64.npz`` at 64^2 x 128 spp with both tracers
under the rule of ``tests/test_golden_images.py``: PSNR > 26 dB and the
mean within 3 %."""

import importlib
import os

import numpy as np
import pytest
import torch

from libfluid_tpu_torch.config import RenderConfig
from libfluid_tpu_torch.renderer import SceneBuilder, intersect, scenes
from libfluid_tpu_torch.renderer.pathtrace import trace_rays
from libfluid_tpu_torch.renderer.scene import unit_box

render_mod = importlib.import_module("libfluid_tpu_torch.renderer.render")

torch.set_num_threads(1)

_GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _psnr(a, b):
    mse = float(np.mean((a - b) ** 2))
    peak = float(max(a.max(), b.max(), 1e-6))
    return 10.0 * np.log10(peak * peak / max(mse, 1e-20))


def test_furnace_closed_box():
    """Inside a closed emissive lambertian box the estimate is exactly
    E * sum_{k<B} rho^k: cosine sampling cancels the BSDF term."""
    rho, e = 0.6, 0.8
    b = SceneBuilder()
    m = b.lambertian((rho, rho, rho), emission=(e, e, e))
    pos, idx = unit_box()
    b.add_mesh(pos, idx, m, np.asarray([[20.0, 0, 0, 0], [0, 20.0, 0, 0], [0, 0, 20.0, 0]]))
    scene = b.finish(device="cpu")
    cfg = RenderConfig(max_bounces=4)
    d = torch.randn((256, 3), generator=_gen(0))
    li = trace_rays(scene, torch.zeros((256, 3)), d, _gen(1), cfg)
    np.testing.assert_allclose(li.numpy(), e * sum(rho**k for k in range(cfg.max_bounces)), rtol=1e-4)


@pytest.mark.parametrize("differentiable", [True, False], ids=["fixed-count", "persistent"])
def test_cornell_box_render(differentiable):
    builder, cam = scenes.cornell_box_one_light(1.0, device="cpu")
    scene = builder.finish(device="cpu")
    cfg = RenderConfig(width=64, height=64, samples_per_pixel=24, max_bounces=4,
                       differentiable=differentiable, ray_batch=4096)
    img = render_mod.render(scene, cam, cfg, _gen(0), device="cpu").numpy()
    assert np.isfinite(img).all() and img.min() >= 0.0
    assert img.mean() > 0.05
    assert img[: img.shape[0] // 6, 24:40].mean() > img.mean()  # the ceiling light
    left, right = img[16:56, :8], img[16:56, 56:]
    assert left[..., 0].mean() > 4.0 * left[..., 1].mean()  # the red wall, screen left
    assert right[..., 1].mean() > right[..., 0].mean()  # the green wall, screen right
    assert left[..., 0].mean() > right[..., 0].mean()
    assert right[..., 1].mean() > left[..., 1].mean()


def test_mirror_reflection_geometry():
    b = SceneBuilder()
    mirror = b.mirror()
    light = b.lambertian((0, 0, 0), emission=(5.0, 5.0, 5.0))
    idx = np.array([0, 2, 1, 0, 3, 2])
    b.add_mesh(np.array([[-10, 0, -10], [10, 0, -10], [10, 0, 10], [-10, 0, 10.0]]), idx, mirror)
    b.add_mesh(np.array([[1, 1, 2], [2, 1, 2], [2, 2, 2], [1, 2, 2.0]]), idx, light)
    scene = b.finish(device="cpu")
    cfg = RenderConfig(max_bounces=3)
    d = torch.tensor([[0.0, -1.5, 1.5]])
    li = trace_rays(scene, torch.tensor([[1.5, 1.5, -1.0]]), d, _gen(0), cfg)
    np.testing.assert_allclose(li.numpy()[0], 5.0, rtol=1e-5)
    li2 = trace_rays(scene, torch.tensor([[5.0, 1.5, -1.0]]), d, _gen(0), cfg)
    np.testing.assert_allclose(li2.numpy()[0], 0.0, atol=1e-6)


def test_glass_ior1_is_transparent():
    b = SceneBuilder()
    glass = b.glass(1.0)
    light = b.lambertian((0, 0, 0), emission=(3.0, 3.0, 3.0))
    b.add_sphere(np.asarray([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]]), glass)
    b.add_mesh(np.array([[-1, -1, 5], [1, -1, 5], [1, 1, 5], [-1, 1, 5.0]]), np.array([0, 1, 2, 0, 2, 3]), light)
    scene = b.finish(device="cpu")
    li = trace_rays(scene, torch.tensor([[0.0, 0.0, -3.0]]), torch.tensor([[0.0, 0.0, 1.0]]), _gen(0),
                    RenderConfig(max_bounces=4))
    np.testing.assert_allclose(li.numpy()[0], 3.0, rtol=1e-4)


def test_visibility():
    b = SceneBuilder()
    pos, idx = unit_box()
    b.add_mesh(pos, idx, b.lambertian((0.5, 0.5, 0.5)))
    scene = b.finish(device="cpu")
    vis = intersect.test_visibility(scene, torch.tensor([[0.0, 0.0, -5.0], [0.0, 5.0, -5.0]]),
                                    torch.tensor([[0.0, 0.0, 5.0], [0.0, 5.0, 5.0]])).numpy()
    assert not vis[0] and vis[1]


def test_render_refuses_what_is_not_ported_or_elsewhere():
    builder, cam = scenes.cornell_box_one_light(1.0, device="cpu")
    scene = builder.finish(device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        render_mod.render(scene, cam, RenderConfig(width=4, height=4, algorithm="bdpt"), _gen(0), device="cpu")
    with pytest.raises(ValueError):
        render_mod.render(scene, cam, RenderConfig(width=4, height=4), _gen(0), device="meta")
    acc, n = render_mod.accumulate(scene, cam, RenderConfig(width=4, height=4, ray_batch=16), _gen(0),
                                   torch.zeros((4, 4, 3)), 0, device="cpu")
    assert n == 1 and acc.shape == (4, 4, 3) and float(acc.sum()) > 0


@pytest.mark.parametrize("differentiable", [True, False], ids=["fixed-count", "persistent"])
@pytest.mark.parametrize("name", ["cornell", "glass"])
def test_golden_render(name, differentiable):
    golden = np.load(os.path.join(_GOLDEN, f"{name}_64.npz"))["img"]
    mk = {"cornell": scenes.cornell_box_one_light, "glass": scenes.glass_ball_box}[name]
    b, cam = mk(1.0, device="cpu")
    # one strip of the image's own size (the JAX package's default of 32768
    # rays pads this image's strip eightfold)
    cfg = RenderConfig(width=64, height=64, samples_per_pixel=128, max_bounces=5,
                       differentiable=differentiable, ray_batch=4096)
    img = render_mod.render(b.finish(device="cpu"), cam, cfg, _gen(7), device="cpu").numpy()
    assert np.isfinite(img).all()
    p = _psnr(img, golden)
    assert p > 26.0, f"{name}: PSNR {p:.1f} dB against the golden image"
    np.testing.assert_allclose(img.mean(), golden.mean(), rtol=0.03)
