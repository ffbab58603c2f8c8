"""Checkpoint / resume of simulation state (port of
``libfluid_tpu.checkpoint``).

A checkpoint is a dependency-free ``.npz`` snapshot of the *complete*
state: particles, grid, sources, the CPU ``torch.Generator``'s state (the
port's stand-in for the JAX package's PRNG key) and the simulation time.
Every leaf is addressed by its path of field names and indices, so any
nesting of NamedTuples, tuples, lists and dicts (``SimState`` ->
``MacGrid``/``SourceSet``) round-trips without bespoke code; a leaf the
file lacks keeps the template's value with ``strict=False``. Written with
numpy and json only, in the JAX package's file layout.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from libfluid_tpu_torch.config import resolve_device

FORMAT_VERSION = 1
_MANIFEST = "__manifest__"


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(key path, leaf) pairs in order; a leaf is a tensor, a generator or
    anything else that is not a container."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(name, getattr(tree, name)) for name in tree._fields]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    elif isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    else:
        return [(".".join(prefix) or "_root", tree)]
    out = []
    for name, v in items:
        out += _flatten(v, prefix + (name,))
    return out


def _unflatten(tree, leaves):
    """`tree` with its leaves replaced, in :func:`_flatten`'s order, by the
    iterator `leaves`."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(getattr(tree, n), leaves) for n in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str, state: Any, metadata: Optional[dict] = None) -> None:
    """Write `state` (any nesting of tensors and generators) to `path`
    (.npz), atomically."""
    arrays = {key: _to_numpy(leaf) for key, leaf in _flatten(state)}
    manifest = {"version": FORMAT_VERSION, "keys": sorted(arrays), "metadata": metadata or {}}
    arrays[_MANIFEST] = np.frombuffer(json.dumps(manifest).encode("utf-8"), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _manifest(data) -> dict:
    return json.loads(bytes(data[_MANIFEST]).decode("utf-8"))


def metadata(path: str) -> dict:
    """Read just the metadata dict of a checkpoint."""
    with np.load(path) as data:
        return _manifest(data).get("metadata", {})


def restore(path: str, like: Any, strict: bool = True, device=None) -> Any:
    """Load a checkpoint into the structure of `like` (a template, e.g.
    ``new_state(cfg, device)``) on `device` (None: the CUDA card; ``"cpu"``
    on request). Leaves present in the file replace the template's; with
    ``strict=False`` missing leaves keep the template's value. Shapes must
    match the template's (a capacity change is a re-seeding problem, not a
    load problem); dtypes are cast to the template's. A generator leaf is
    restored as a new CPU generator in the saved state.

    The JAX package's ``sharding`` argument has no counterpart until the
    port has a sharded state (``parallel/``)."""
    device = resolve_device(device)
    with np.load(path) as data:
        manifest = _manifest(data)
        if manifest["version"] > FORMAT_VERSION:
            raise ValueError(f"checkpoint version {manifest['version']} is newer than supported "
                             f"{FORMAT_VERSION}")
        stored = {k: data[k] for k in manifest["keys"]}

    out, used = [], set()
    for key, tmpl in _flatten(like):
        if key not in stored:
            if strict:
                raise KeyError(f"checkpoint is missing leaf {key!r}")
            out.append(tmpl)
            continue
        arr = stored[key]
        used.add(key)
        if isinstance(tmpl, torch.Generator):
            gen = torch.Generator()
            gen.set_state(torch.from_numpy(arr.astype(np.uint8)))
            out.append(gen)
            continue
        shape = tuple(tmpl.shape) if hasattr(tmpl, "shape") else np.shape(tmpl)
        if tuple(arr.shape) != shape:
            raise ValueError(f"checkpoint leaf {key!r} has shape {arr.shape}, template expects {shape}")
        if isinstance(tmpl, torch.Tensor):
            out.append(torch.from_numpy(np.array(arr)).to(device=device, dtype=tmpl.dtype))
        else:
            out.append(arr.astype(np.asarray(tmpl).dtype))
    extra = set(stored) - used
    if extra and strict:
        raise KeyError(f"checkpoint has unknown leaves: {sorted(extra)}")
    return _unflatten(like, iter(out))
