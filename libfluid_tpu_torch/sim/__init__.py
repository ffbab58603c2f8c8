"""Simulation pipeline: the APIC/PIC particle-in-cell liquid substep in
PyTorch, with hand-written CUDA kernels on the hot path."""

from libfluid_tpu_torch.sim.state import SimState, SourceSet, new_state, seed_box, seed_sphere, seed_func
from libfluid_tpu_torch.sim.step import step, substep, cfl_dt, Diagnostics

__all__ = [
    "SimState",
    "SourceSet",
    "new_state",
    "seed_box",
    "seed_sphere",
    "seed_func",
    "step",
    "substep",
    "cfl_dt",
    "Diagnostics",
]
