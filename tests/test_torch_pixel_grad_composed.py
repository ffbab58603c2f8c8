"""The composed pixel gradient of the port against ``jax.grad`` of the JAX
package: pixels -> render -> marching cubes -> one 16^3 substep -> initial
velocities (``test_pixel_grad_fd.test_pixel_grad_composed_sim_to_pixels_allclose_fd``),
with position correction off and on, at the gate's 8x8 x 2 spp and with a
textured water at 16x16 x 2 spp. The scenes, draws and tolerances are
those of ``test_torch_pixel_grad.py``: 5e-3 of the largest entry of the
JAX gradient (the substep gradient's own tolerance is 1e-3, and the mesher
and renderer follow); where that gradient is zero, the port's must be
zero too."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu.config import MesherConfig as JMesherConfig
from libfluid_tpu.config import RenderConfig as JRenderConfig
from libfluid_tpu.config import SimConfig as JSimConfig
from libfluid_tpu.config import TransferScheme as JScheme
from libfluid_tpu.renderer.camera import Camera as JCamera
from libfluid_tpu.renderer.scene import SceneBuilder as JBuilder
from libfluid_tpu import sim as jsim
from libfluid_tpu_torch import convert
from libfluid_tpu_torch import sim as tsim
from libfluid_tpu_torch.config import MesherConfig, RenderConfig
from libfluid_tpu_torch.mesher.marching_cubes import marching_cubes
from libfluid_tpu_torch.mesher.surface import sample_surface
from libfluid_tpu_torch.renderer.camera import Camera
from libfluid_tpu_torch.renderer.render import render
from libfluid_tpu_torch.renderer.scene import SceneBuilder, inject_mesh

from jax_draws import JaxDraws
from test_torch_pixel_grad import _CFG, KEY, _agree, _j_pixel_grad_to_positions, _lit_box, _torch_grad
from test_torch_substep import JaxDraws as SubstepDraws
from test_torch_substep import _state_arrays

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _composed(correction: bool):
    """The composed gate's 16^3 blob and configurations, and the jitted
    VJP of one substep of 0.05 (end positions <- initial velocities)."""
    cfg = JSimConfig(grid_size=(16, 16, 16), cell_size=1.0, gravity=(0.0, -10.0, 0.0),
                     particle_capacity=1 << 13, scheme=JScheme.APIC, has_obstacles=False,
                     enable_position_correction=correction)
    state = jsim.new_state(cfg, jax.random.PRNGKey(3))
    state = jsim.seed_box(state, cfg, (5.0, 2.0, 5.0), (11.0, 6.0, 11.0))
    mkw = dict(grid_size=(16, 16, 16), cell_size=1.0, grid_offset=(0.0, 0.0, 0.0), max_triangles=1 << 11)

    @jax.jit
    def substep_vjp(vel0, g_pos):
        end, vjp = jax.vjp(lambda v: jsim.substep(state._replace(velocity=v), cfg, 0.05)[0].position, vel0)
        return end, vjp(g_pos)[0]

    @jax.jit
    def end_state(vel0):
        st, _ = jsim.substep(state._replace(velocity=vel0), cfg, 0.05)
        return st.position, st.active

    return cfg, state, JMesherConfig(**mkw), MesherConfig(**mkw), end_state, substep_vjp


@pytest.mark.parametrize("correction,textured", [(False, False), (True, False), (False, True), (True, True)],
                         ids=["correction-off", "correction-on", "textured-correction-off",
                              "textured-correction-on"])
def test_composed_grad_matches_jax(correction, textured):
    """Pixels -> render -> marching cubes -> one substep of 0.05 ->
    initial velocities (``test_pixel_grad_composed_sim_to_pixels_allclose_fd``),
    and the same with position correction on; both at the gate's 8x8 x 2
    spp (a zero gradient on both sides, see the mesher test) and with the
    textured water at 16x16 x 2 spp (not zero). The JAX gradient is taken
    by the chain rule: the substep's jitted VJP of the pixel gradient with
    respect to the end positions."""
    cfg, state0, jm, tm, end_state, substep_vjp = _composed(correction)
    tcfg = convert.config_from_fields(**vars(cfg))
    tstate0 = convert.state_from_numpy(_state_arrays(state0), tcfg, "cpu")
    jb, jwater = _lit_box(JBuilder, 16.0, 15.2, 60.0, textured)
    tb, twater = _lit_box(SceneBuilder, 16.0, 15.2, 60.0, textured)
    jscene0, tscene0 = jb.finish(), tb.finish(device="cpu")
    view = ((8.0, 10.0, 26.0), (8.0, 4.0, 8.0), (0.0, 1.0, 0.0), np.deg2rad(45.0), 1.0)
    jcam = JCamera.from_parameters(*(jnp.asarray(v) for v in view[:3]), *view[3:])
    tcam = Camera.from_parameters(*view, device="cpu")
    res = 16 if textured else 8
    kw = dict(_CFG, width=res, height=res, ray_batch=res * res)
    jcfg, tcfg_r = JRenderConfig(**kw), RenderConfig(**kw)

    pos, act = end_state(state0.velocity)
    g_pos = _j_pixel_grad_to_positions(jscene0, jwater, jcam, jm, jcfg, pos, act)
    _, want = substep_vjp(state0.velocity, g_pos)

    def tloss(vel0):
        st, _ = tsim.substep(tstate0._replace(velocity=vel0), tcfg, 0.05, draws=SubstepDraws(state0.key))
        mesh = marching_cubes(sample_surface(st.position, st.active, tm), tm)
        s = inject_mesh(tscene0, mesh.vertices, mesh.valid, twater)
        return torch.mean(render(s, tcam, tcfg_r, JaxDraws(KEY, jcfg), device="cpu"))

    got = _torch_grad(tloss, state0.velocity)
    assert (float(jnp.abs(want).max()) > 0) == textured
    _agree(got, want, 5e-3)
