"""Copies of the program's state: on the device for the episodes' snapshot,
on the host for the comparison with the reference.

A host copy is plain data: a named tuple becomes a dict of its fields with
its type's name under ``"__type__"``, a tensor a CPU tensor, a CPU
generator its state under ``"__generator__"``. The reference rebuilds its
own types from such a dict by name (``reference/state_io.py``).
"""

from __future__ import annotations

import torch


def _is_named_tuple(obj) -> bool:
    return isinstance(obj, tuple) and hasattr(obj, "_fields")


def to_host(obj):
    """A host copy of `obj` (a named tuple of tensors, possibly nested)."""
    if _is_named_tuple(obj):
        out = {"__type__": type(obj).__name__}
        out.update({f: to_host(getattr(obj, f)) for f in obj._fields})
        return out
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, torch.Generator):
        return {"__generator__": obj.get_state()}
    return obj


def clone(obj):
    """A copy of `obj` on its own device: tensors cloned, a generator
    replaced by a new one in the same state, so that running from the copy
    leaves `obj` as it was."""
    if _is_named_tuple(obj):
        return type(obj)(*(clone(v) for v in obj))
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, torch.Generator):
        g = torch.Generator(device=obj.device)
        g.set_state(obj.get_state())
        return g
    return obj
