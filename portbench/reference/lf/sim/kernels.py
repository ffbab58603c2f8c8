"""The dispatch points of the port's kernels, in the frozen copy: every
stage takes its plain PyTorch version, on any device.

The port's ``sim/kernels.py`` sends CUDA tensors to its hand-written
kernels and CPU tensors to the plain versions. The copy keeps only the
plain side, so the reference computes each stage as the port's CPU path
does, also on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from portbench.reference.lf.config import SimConfig


def use_kernel(*tensors: torch.Tensor) -> bool:
    """False: the reference has no kernels. Raises for tensors on different
    devices, as the port's dispatch does."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on different devices: {[t.device for t in tensors]}")
    return False


def face_shapes(cfg: SimConfig):
    """Shapes of the u, v, w face arrays."""
    nx, ny, nz = cfg.grid_size
    return [(nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)]


def p2g_faces(data: torch.Tensor, cfg: SimConfig) -> Tuple[tuple, tuple]:
    """UNNORMALIZED face accumulators ((num_u, num_v, num_w), (den_u, den_v,
    den_w)) of the slot payload (16, K, nx, ny, nz): the plain
    ``transfers._p2g_slots_torch``."""
    from portbench.reference.lf.sim import transfers

    num, den = transfers._p2g_slots_torch(data, cfg)
    return tuple(num), tuple(den)
