"""Kernel ``pathtrace`` (``csrc/pathtrace.cu``), the persistent tracer with
the accelerator on the card, against its plain loop
(``pathtrace._trace_persistent_mega``) on the card. Marked ``card``: without
a CUDA card it skips. This file imports no JAX, so on the card it runs with
``python -m pytest --noconftest tests/test_torch_pathtrace_card.py``.

:func:`small_fluid_scene` is also the scene of the CPU tests of the
persistent tracer in ``test_torch_pathtrace.py``."""

import types

import numpy as np
import pytest
import torch

from libfluid_tpu_torch import profiling
from libfluid_tpu_torch.config import RenderConfig
from libfluid_tpu_torch.math import transforms
from libfluid_tpu_torch.renderer import accel, draws, loops, pathtrace, scenes
from libfluid_tpu_torch.sim import kernels

# 16^2 x 2 spp, 4 bounces, the roulette from the second bounce on
SMALL = RenderConfig(width=16, height=16, samples_per_pixel=2, max_bounces=4, rr_start=1, differentiable=False)


def small_fluid_scene(device):
    """The fluid box around an 8^3 domain with a bumpy sheet of 32 water
    triangles and a sphere, its accelerator at 8^3, and its camera."""
    b, cam = scenes.fluid_box((0.0, 0.0, 0.0), (8.0, 8.0, 8.0), device=device)
    water = b.lambertian((0.4, 0.55, 0.8))
    x, z = np.meshgrid(np.linspace(0.5, 7.5, 5), np.linspace(0.5, 7.5, 5), indexing="ij")
    p = np.stack([x, 3.0 + 0.6 * np.sin(x) * np.cos(z), z], -1)
    quads = np.stack([p[:-1, :-1], p[1:, :-1], p[1:, 1:], p[:-1, 1:]], 2).reshape(-1, 4, 3)
    b.add_triangle_soup(np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]]), water)
    b.add_sphere(transforms.scale_rotate_translate(1.2, (0.3, 0.2, 0.1), (4.0, 5.2, 3.0)).numpy(),
                 b.lambertian((0.8, 0.3, 0.3)))
    scene = b.finish(device=device)
    return scene._replace(accel=accel.build(scene, res=(8, 8, 8), device=device)), cam


@pytest.fixture
def card():
    """The CUDA card; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.card
def test_the_card_renders_with_one_launch_of_the_kernel(card):
    """A render with the accelerator on the card is one launch of the
    kernel, counted ``pathtrace.kernel``, with no host read; its image and
    rays cast are the plain loop's on the card (the same draws: paths equal
    but for the image's float atomics); a provider that is not a HashDraws
    raises."""
    scene, cam = small_fluid_scene(card)
    want, want_cast = pathtrace._trace_persistent_mega(scene, cam, SMALL, draws.HashDraws(5), True)
    kernels.reset_launches()
    loops.reset_host_reads()
    profiling.clear()
    with profiling.tracing():
        got, cast = pathtrace.trace_persistent(scene, cam, SMALL, draws.HashDraws(5), True)
        torch.cuda.synchronize()
    record = profiling.frames()[-1]
    profiling.clear()
    assert kernels.LAUNCHES["pathtrace"] == 1 and loops.HOST_READS["count"] == 0
    assert (record.total("pathtrace.kernel"), record.total("pathtrace.plain")) == (1, 0)
    assert int(cast) == int(want_cast)
    assert float(got.mean()) > 0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(TypeError, match="HashDraws"):
        pathtrace.trace_persistent(scene, cam, SMALL, types.SimpleNamespace(lane=draws.HashDraws(5).lane))
    assert kernels.LAUNCHES["pathtrace"] == 1
