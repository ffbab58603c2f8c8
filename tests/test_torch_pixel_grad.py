"""Pixel gradients of the port (``torch.autograd`` through ``render``)
against ``jax.grad`` of the JAX package on the five gates of
``tests/test_pixel_grad_fd.py`` (emission, albedo, the glass IOR, particle
positions through the mesher, initial velocities through a 16^3 substep,
the mesher and the renderer: in ``test_torch_pixel_grad_composed.py``,
with the composed gate with position correction on), with the JAX
package's random numbers injected (the render's through ``JaxDraws``, the
substep's through the substep tests' ``JaxDraws``). Images of 8x8 x 2 spp, 3 bounces, one strip of 64 rays a
sample (the estimator's draws follow the strip, so both sides use it).

Tolerances, each against the largest entry of the JAX gradient: 1e-4 for
emission and albedo (the radiance is polynomial in them); 1e-3 for the
IOR (the Fresnel chain in float32); 2e-3 through the mesher; 5e-3
through the substep (the substep gradient's own tolerance is 1e-3, and the
mesher and renderer follow). Where the JAX gradient is zero (three of the
gates: a path's weight in these scenes does not depend on where a surface
is hit, see the tests), the port's must be zero too; the mesher and
composed gates are also taken with a textured water, whose gradient is
not zero.

Also: the hit search under autograd (``intersect._brute_force_tris``: the
search without grad, then t, u, v recomputed on the chosen triangle) gives
the same bits and the same gradient as the search run under grad."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu.config import MesherConfig as JMesherConfig
from libfluid_tpu.config import RenderConfig as JRenderConfig
from libfluid_tpu.mesher.marching_cubes import marching_cubes as j_mc
from libfluid_tpu.mesher.surface import sample_surface as j_surface
from libfluid_tpu.renderer import scenes as jscenes
from libfluid_tpu.renderer.camera import Camera as JCamera
from libfluid_tpu.renderer.render import render as jrender
from libfluid_tpu.renderer.scene import SceneBuilder as JBuilder
from libfluid_tpu.renderer.scene import inject_mesh as j_inject
from libfluid_tpu_torch.config import MesherConfig, RenderConfig
from libfluid_tpu_torch.mesher.marching_cubes import marching_cubes
from libfluid_tpu_torch.mesher.surface import sample_surface
from libfluid_tpu_torch.renderer import intersect, scenes
from libfluid_tpu_torch.renderer.camera import Camera
from libfluid_tpu_torch.renderer.render import render
from libfluid_tpu_torch.renderer.scene import SceneBuilder, inject_mesh

from jax_draws import JaxDraws

torch.set_num_threads(1)

_CFG = dict(width=8, height=8, samples_per_pixel=2, max_bounces=3, ray_batch=64)
JCFG = JRenderConfig(**_CFG)
TCFG = RenderConfig(**_CFG)
KEY = jax.random.PRNGKey(7)


def _draws():
    return JaxDraws(KEY, JCFG)


def _agree(got, want, rel):
    """Within `rel` of the largest entry of `want`; where `want` is all
    zero, `got` must be all zero too."""
    want = np.asarray(want, np.float64)
    got = got.detach().numpy().astype(np.float64)
    assert np.isfinite(want).all() and np.isfinite(got).all()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _torch_grad(loss, x0):
    x = torch.from_numpy(np.array(x0)).requires_grad_()
    (g,) = torch.autograd.grad(loss(x), x)
    return g


@pytest.mark.parametrize("field,rel", [("emission", 1e-4), ("albedo", 1e-4)])
def test_material_grad_matches_jax(field, rel):
    jb, jcam = jscenes.cornell_box_one_light(1.0)
    jscene = jb.finish()
    tb, tcam = scenes.cornell_box_one_light(1.0, device="cpu")
    tscene = tb.finish(device="cpu")

    def jloss(x):
        s = jscene._replace(materials=jscene.materials._replace(**{field: x}))
        return jnp.mean(jrender(s, jcam, JCFG, KEY))

    def tloss(x):
        s = tscene._replace(materials=tscene.materials._replace(**{field: x}))
        return torch.mean(render(s, tcam, TCFG, _draws(), device="cpu"))

    x0 = getattr(jscene.materials, field)
    _agree(_torch_grad(tloss, x0), jax.jit(jax.grad(jloss))(x0), rel)


def test_glass_ior_grad_matches_jax():
    """The glass ball's IOR. The gradient is zero on both sides: the
    dielectric's Fresnel weight cancels against its pick probability, and
    a path that enters the ball leaves it, so eta^2 cancels too; the IOR
    moves only where a path goes, which autodiff does not see."""
    jb, jcam = jscenes.glass_ball_box(1.0)
    jscene = jb.finish()
    tb, tcam = scenes.glass_ball_box(1.0, device="cpu")
    tscene = tb.finish(device="cpu")

    def jloss(ior):
        return jnp.mean(jrender(jscene._replace(materials=jscene.materials._replace(ior=ior)), jcam, JCFG, KEY))

    def tloss(ior):
        s = tscene._replace(materials=tscene.materials._replace(ior=ior))
        return torch.mean(render(s, tcam, TCFG, _draws(), device="cpu"))

    x0 = jscene.materials.ior
    _agree(_torch_grad(tloss, x0), jax.jit(jax.grad(jloss))(x0), 1e-3)


def _lit_box(builder, n: float, lamp_y: float, emission: float, textured: bool = False):
    """The gates' lit floor and lamp around an n-wide domain, and the
    water material (with `textured`, its albedo modulated by a smooth 8x8
    ramp at the hit's barycentric uv), with either package's
    SceneBuilder."""
    b = builder()
    white = b.lambertian((0.75, 0.75, 0.75))
    light = b.lambertian((0.8, 0.8, 0.8), emission=(emission,) * 3)
    tex = 0
    if textured:
        u = np.linspace(0.0, 1.0, 8)
        ramp = np.stack([0.2 + 0.8 * np.broadcast_to(u[None, :], (8, 8)),
                         0.2 + 0.8 * np.broadcast_to(u[:, None], (8, 8)), np.full((8, 8), 0.6)], -1)
        tex = b.add_texture(ramp)
    water = b.lambertian((0.4, 0.55, 0.8), albedo_tex=tex)
    floor = np.array([[n, 0, n], [0, 0, n], [0, 0, 0], [n, 0, 0]], float)
    b.add_mesh(floor, np.array([[0, 1, 2], [0, 2, 3]]), white)
    lo, hi = 0.3125 * n, 0.6875 * n
    lamp = np.array([[hi, lamp_y, hi], [lo, lamp_y, hi], [lo, lamp_y, lo], [hi, lamp_y, lo]], float)
    b.add_mesh(lamp, np.array([[0, 2, 1], [0, 3, 2]]), light)
    return b, water


def _j_pixel_grad_to_positions(jscene0, jwater, jcam, jm, jcfg, pos, act):
    """``jax.grad`` of the mean pixel with respect to the particle
    positions, by the chain rule in two pieces: the jitted gradient of
    render(inject(marching_cubes(sdf))) with respect to the node samples,
    then the VJP of ``sample_surface`` run eagerly (jitted, its scatter
    over the support's offsets compiles for minutes on the CPU)."""
    def from_sdf(sdf):
        mesh = j_mc(sdf, jm)
        return jnp.mean(jrender(j_inject(jscene0, mesh.vertices, mesh.valid, jwater), jcam, jcfg, KEY))

    sdf, vjp = jax.vjp(lambda p: j_surface(p, act, jm), pos)
    return vjp(jax.jit(jax.grad(from_sdf))(sdf))[0]


@pytest.mark.parametrize("textured,res", [(False, 8), (True, 16)], ids=["gate", "textured"])
def test_mesher_grad_matches_jax(textured, res):
    """Pixels -> marching cubes -> ``sample_surface`` -> particle positions
    (``test_pixel_grad_through_mesher_allclose_fd``'s scene and blob). At
    the gate's 8x8 x 2 spp the gradient is zero on both sides: a lambertian
    surface of constant albedo lit by a constant emitter gives a path
    weight that does not depend on where it is hit (cosine sampling cancels
    the BSDF), so only visibility changes, which autodiff does not see.
    The textured case (the water's albedo a ramp over the hit's uv, 16x16)
    gives a gradient that is not zero."""
    jb, jwater = _lit_box(JBuilder, 8.0, 7.6, 40.0, textured)
    tb, twater = _lit_box(SceneBuilder, 8.0, 7.6, 40.0, textured)
    jscene0, tscene0 = jb.finish(), tb.finish(device="cpu")
    view = ((4.0, 5.0, 12.0), (4.0, 2.0, 4.0), (0.0, 1.0, 0.0), np.deg2rad(45.0), 1.0)
    jcam = JCamera.from_parameters(*(jnp.asarray(v) for v in view[:3]), *view[3:])
    tcam = Camera.from_parameters(*view, device="cpu")
    mkw = dict(grid_size=(10, 8, 10), cell_size=0.8, grid_offset=(0.0, 0.0, 0.0), max_triangles=512)
    jm, tm = JMesherConfig(**mkw), MesherConfig(**mkw)
    kw = dict(_CFG, width=res, height=res, ray_batch=res * res)
    jcfg, tcfg = JRenderConfig(**kw), RenderConfig(**kw)
    rng = np.random.default_rng(11)
    pos0 = (np.array([4.0, 2.0, 4.0]) + rng.normal(0, 0.7, (48, 3))).astype(np.float32)
    act = np.ones((48,), bool)

    def tloss(pos):
        mesh = marching_cubes(sample_surface(pos, torch.from_numpy(act), tm), tm)
        s = inject_mesh(tscene0, mesh.vertices, mesh.valid, twater)
        return torch.mean(render(s, tcam, tcfg, JaxDraws(KEY, jcfg), device="cpu"))

    want = _j_pixel_grad_to_positions(jscene0, jwater, jcam, jm, jcfg, jnp.asarray(pos0), jnp.asarray(act))
    got = _torch_grad(tloss, pos0)
    assert (float(jnp.abs(want).max()) > 0) == textured
    _agree(got, want, 2e-3)


def test_search_without_grad_matches_search_under_grad():
    """A fluid-like scene: a mesh blob of a few hundred triangles over two
    chunks in the Cornell box, rays from inside the box; the hit search of
    ``_brute_force_tris`` under autograd gives the bits of the plain search
    (``_search_tris``, run under grad) and the same gradient with respect
    to the triangles and the rays."""
    tm = MesherConfig(grid_size=(10, 8, 10), cell_size=0.8, grid_offset=(0.0, 0.0, 0.0), max_triangles=1024)
    rng = np.random.default_rng(4)
    pos = torch.from_numpy((np.array([4.0, 2.0, 4.0]) + rng.normal(0, 0.9, (64, 3))).astype(np.float32))
    mesh = marching_cubes(sample_surface(pos, torch.ones((64,), dtype=torch.bool), tm), tm)
    b, _ = scenes.cornell_box_one_light(1.0, device="cpu")
    scene = inject_mesh(b.finish(device="cpu"), mesh.vertices, mesh.valid, 1)
    assert scene.tri_p0.shape[0] > intersect.TRI_CHUNK
    o = torch.from_numpy(rng.uniform(0.5, 7.5, (512, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(512, 3)).astype(np.float32))

    def run(search):
        leaves = [t.clone().requires_grad_() for t in (scene.tri_p0, scene.tri_e1, scene.tri_e2, o, d)]
        s = scene._replace(tri_p0=leaves[0], tri_e1=leaves[1], tri_e2=leaves[2])
        t, tid, u, v = search(s, leaves[3], leaves[4], 3.0e38)
        hit = tid >= 0
        loss = torch.sum(torch.where(hit, t * 0.3 + u - 2.0 * v, torch.zeros_like(t)))
        return (t, tid, u, v), torch.autograd.grad(loss, leaves)

    got, g_got = run(intersect._brute_force_tris)
    want, g_want = run(intersect._search_tris)
    assert int((want[1] >= 0).sum()) > 100
    for a, b2 in zip(got, want):
        assert torch.equal(a, b2)
    for a, b2 in zip(g_got, g_want):
        torch.testing.assert_close(a, b2, rtol=1e-6, atol=1e-6)
