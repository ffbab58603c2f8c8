"""The control: the reference put in the program's place, with everything it
keeps between stages in bfloat16, the next precision below the float32
that the configurations state. After every substep the particles'
positions, velocities and APIC matrices, the face velocities and the
pressure are rounded to bfloat16 (the arithmetic stays float32), as are
the mesh's corners and the image. It is the step that would tempt a later
change (half the bytes of the particle state), and the comparison has to
find it out.

:class:`Control` has the part of ``portbench.system.Program``'s interface
that a frame's actions use.
"""

from __future__ import annotations

import torch

from portbench.reference import state_io
from portbench.reference.compare import Reference
from portbench.reference.lf.mesher import marching_cubes
from portbench.reference.lf.sim import step as step_mod


def _round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def rounded_state(state):
    """`state` with what a substep hands the next rounded to bfloat16."""
    grid = state.grid._replace(u=_round(state.grid.u), v=_round(state.grid.v), w=_round(state.grid.w))
    return state._replace(position=_round(state.position), velocity=_round(state.velocity),
                          affine=_round(state.affine), grid=grid, pressure=_round(state.pressure))


def step(state, cfg, dt):
    """The reference's CFL step (``sim/step.py:step``) with the state rounded
    to bfloat16 after every substep."""
    dev = state.position.device
    remaining = torch.as_tensor(dt, dtype=cfg.dtype, device=dev)
    diag, nsub = None, 0
    while bool(remaining > 0.0):
        ts = torch.minimum(cfg.cfl_number * step_mod.cfl_dt(state, cfg), remaining)
        state, diag = step_mod.substep(state, cfg, ts)
        state = rounded_state(state)
        remaining = remaining - ts
        nsub += 1
    return state, diag._replace(substeps=torch.tensor(nsub, dtype=torch.int32, device=dev))


class _Mesh:
    """A mesh with its corners rounded to bfloat16."""

    def __init__(self, mesh):
        self.vertices = _round(mesh.vertices)
        self.count = mesh.count
        self.valid = mesh.valid


class Control:
    """The control on `device`, in the program's place."""

    def __init__(self, device):
        self.device = torch.device(device)

    def sim_config(self, conf):
        return state_io.sim_config(conf)

    def mesher_config(self, conf):
        return state_io.mesher_config(conf)

    def render_config(self, conf):
        return state_io.render_config(conf)

    def from_program(self, host_state):
        """The control's state from a host copy of the program's."""
        return state_io.from_host(host_state, self.device)

    def step(self, state, cfg, dt):
        return step(state, cfg, dt)

    def mesh(self, state, mcfg):
        return _Mesh(marching_cubes.generate_mesh(state.position, state.active, mcfg))

    def base_scene(self, conf):
        self._ref = Reference(conf, self.device)
        return self._ref.base_scene()

    def scene(self, scene0, mesh, water, accel_res):
        return self._ref.scene(scene0, mesh.vertices, mesh.valid, water)

    def render(self, scene, cam, rcfg, seed: int):
        img, cast = self._ref.trace(scene, cam, seed)
        return _round(img), cast
