"""Carry a configuration and a simulation state over between the JAX package
and this port, through plain Python values and numpy arrays (no JAX import).

A state travels as a flat dict of numpy arrays with the keys of
:data:`STATE_KEYS`: the particle SoA, the grid's faces and cell types, the
solid mask, the warm-start pressure and the time.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from libfluid_tpu_torch import grids
from libfluid_tpu_torch.config import SimConfig, SolverConfig, TransferScheme
from libfluid_tpu_torch.sim.state import SimState, empty_sources

STATE_KEYS = (
    "position", "velocity", "affine", "active", "u", "v", "w", "cell_type",
    "solid", "pressure", "time",
)

def config_from_fields(**fields) -> SimConfig:
    """A :class:`SimConfig` from the fields of a JAX ``SimConfig`` (for
    example ``vars(cfg)``). The scheme may be any enum with the same values,
    the solver any object with ``SolverConfig``'s fields; the dtype must be
    float32 (the kernels take nothing else)."""
    fields = dict(fields)
    if "scheme" in fields:
        scheme = fields["scheme"]
        fields["scheme"] = TransferScheme(getattr(scheme, "value", scheme))
    if "solver" in fields:
        solver = fields["solver"]
        if not isinstance(solver, Mapping):
            solver = {f.name: getattr(solver, f.name) for f in dataclasses.fields(SolverConfig)}
        fields["solver"] = SolverConfig(**solver)
    if "dtype" in fields:
        dtype = fields["dtype"]
        name = str(dtype) if isinstance(dtype, torch.dtype) else f"torch.{np.dtype(dtype)}"
        if name != "torch.float32":
            raise ValueError(f"unsupported dtype {dtype!r}; the port runs float32")
        fields["dtype"] = torch.float32
    return SimConfig(**fields)


def state_from_numpy(arrays: Mapping[str, np.ndarray], cfg: SimConfig, device=None) -> SimState:
    """The port's :class:`SimState` on `device` from a flat dict of numpy
    arrays (:data:`STATE_KEYS`). The state has no sources and no generator."""
    missing = [k for k in STATE_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"state arrays missing {missing}")

    def t(key, dtype):
        return torch.as_tensor(np.array(arrays[key]), dtype=dtype, device=device)

    f = cfg.dtype
    grid = grids.MacGrid(
        u=t("u", f), v=t("v", f), w=t("w", f), cell_type=t("cell_type", torch.int8)
    )
    if grid.grid_size != tuple(cfg.grid_size):
        raise ValueError(f"grid {grid.grid_size} does not match cfg {cfg.grid_size}")
    return SimState(
        position=t("position", f),
        velocity=t("velocity", f),
        affine=t("affine", f),
        active=t("active", torch.bool),
        grid=grid,
        solid=t("solid", torch.bool),
        sources=empty_sources(device),
        generator=None,
        time=t("time", f).reshape(()),
        pressure=t("pressure", f),
    )


def state_to_numpy(state: SimState) -> Dict[str, np.ndarray]:
    """The flat dict of numpy arrays (:data:`STATE_KEYS`) of a port state."""
    values = {
        "position": state.position, "velocity": state.velocity,
        "affine": state.affine, "active": state.active,
        "u": state.grid.u, "v": state.grid.v, "w": state.grid.w,
        "cell_type": state.grid.cell_type, "solid": state.solid,
        "pressure": state.pressure, "time": state.time,
    }
    return {k: v.detach().cpu().numpy() for k, v in values.items()}
