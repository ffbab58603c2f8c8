"""The reference's own configuration objects and states, from a
configuration file's groups and from host copies of the program's state
(``portbench/hostcopy.py``: named tuples as dicts with ``"__type__"``).

The "sim" group may hold keys of the port's ``SimConfig`` that the frozen
reference's does not declare, where the configuration names each of them
in its list ``"program_only"``: the reference leaves them to the program.
Such a key may only change how the port computes (a tiling, a schedule),
never what it computes, so the reference's result is the same without it;
a key that changed the result would show as a gap in the comparison. A key
that the reference declares cannot be left to the program, and any other
key that it does not declare raises here, as a misspelt key does in the
program.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference.lf import config as config_mod
from portbench.reference.lf import grids
from portbench.reference.lf.renderer import accel as accel_mod
from portbench.reference.lf.renderer import scene as scene_mod
from portbench.reference.lf.sim import state as state_mod

# the types a host copy may name, by name
TYPES = {
    "SimState": state_mod.SimState,
    "SourceSet": state_mod.SourceSet,
    "MacGrid": grids.MacGrid,
    "Scene": scene_mod.Scene,
    "Accel": accel_mod.Accel,
}


def _fields(group: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in group.items()}


def program_keys(conf: dict) -> list:
    """The "sim" keys that the configuration leaves to the program (its
    ``"program_only"``); none may be a key that the reference declares."""
    left = list(conf.get("program_only", ()))
    declared = {f.name for f in dataclasses.fields(config_mod.SimConfig)}
    if declared & set(left):
        raise ValueError(f"the reference's SimConfig declares {sorted(declared & set(left))}: "
                         "such a key is not left to the program")
    return left


def sim_config(conf: dict) -> config_mod.SimConfig:
    """The reference's ``SimConfig`` of the "sim" and "solver" groups, from
    every "sim" key but those left to the program."""
    left = program_keys(conf)
    fields = _fields({k: v for k, v in conf["sim"].items() if k not in left})
    fields["scheme"] = config_mod.TransferScheme(fields["scheme"])
    return config_mod.SimConfig(**fields, solver=config_mod.SolverConfig(**conf["solver"]))


def mesher_config(conf: dict) -> config_mod.MesherConfig:
    return config_mod.MesherConfig(**_fields(conf["mesher"]))


def render_config(conf: dict) -> config_mod.RenderConfig:
    return config_mod.RenderConfig(**conf["render"])


def from_host(obj, device):
    """The reference's object for a host copy, its tensors on `device`."""
    if isinstance(obj, dict) and "__generator__" in obj:
        g = torch.Generator()
        g.set_state(obj["__generator__"])
        return g
    if isinstance(obj, dict) and "__type__" in obj:
        cls = TYPES[obj["__type__"]]
        return cls(**{f: from_host(obj[f], device) for f in cls._fields})
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    return obj
