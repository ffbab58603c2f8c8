"""A run with the timed path broken underneath comes out as not correct:
each fault that a cell can have, planted in the program, with the rest of
the run as it is (at 16^3 on the CPU, without the harness's look for a
card). The cells run on one card, so no exchange between cards can be left
out."""

import importlib

import pytest
import torch

from portbench import harness
from portbench.system import Program
from conftest import SMALL


class Unchanged(Program):
    """A step that returns its state unchanged."""

    def step(self, state, cfg, dt):
        _, diag = super().step(state, cfg, dt)
        return state, diag


class HalfLeftOut(Program):
    """P2G over half of the particles (every other slot rank left out), the
    grid's velocities the weighted mean over the rest."""

    def step(self, state, cfg, dt):
        transfers = importlib.import_module("libfluid_tpu_torch.sim.transfers")
        p2g_slots = transfers.p2g_slots

        def half(slot_grid, *args, **kwargs):
            data = slot_grid.data.clone()
            data[:, 1::2] = 0.0
            return p2g_slots(slot_grid._replace(data=data), *args, **kwargs)

        transfers.p2g_slots = half
        try:
            return super().step(state, cfg, dt)
        finally:
            transfers.p2g_slots = p2g_slots


class AnswerAltered(Program):
    """The frame's answer altered where it is made: one particle in 32 one
    cell off."""

    def step(self, state, cfg, dt):
        state, diag = super().step(state, cfg, dt)
        rows = torch.nonzero(state.active).squeeze(1)[::32]
        pos = state.position.clone()
        pos[rows, 0] += cfg.cell_size
        return state._replace(position=pos), diag


class ParticleLost(Program):
    """A step that drops one particle (its diagnostics as if it had not)."""

    def step(self, state, cfg, dt):
        state, diag = super().step(state, cfg, dt)
        active = state.active.clone()
        active[int(torch.nonzero(active)[0])] = False
        return state._replace(active=active), diag


class ImageAltered(Program):
    """The rendered frame altered where it is made: a 4 x 4 block of pixels
    half again as bright."""

    def render(self, scene, cam, rcfg, seed):
        img, cast = super().render(scene, cam, rcfg, seed)
        img = img.clone()
        img[4:8, 4:8] *= 1.5
        return img, cast


FAULTS = [(cell, fault) for cell in sorted(SMALL.values())
          for fault in (Unchanged, HalfLeftOut, AnswerAltered, ParticleLost)]
FAULTS.append(("small64.render", ImageAltered))


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_fault_is_not_correct(tree, cell, fault):
    result, checks, _ = harness.run_cell(harness.Bench(tree), cell, 2**31 + 13, 0.0, False, device="cpu",
                                         system=fault("cpu"))
    assert not result["correct"], checks
