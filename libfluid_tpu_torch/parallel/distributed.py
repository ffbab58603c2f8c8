"""Process-group bring-up on ``torch.distributed`` (port of
``libfluid_tpu.parallel.distributed``).

One process per rank and one device per process: NCCL for CUDA tensors,
gloo for CPU tensors. Nothing tells a process of its cluster, so the caller
names the rendezvous: a ``tcp://127.0.0.1:<port>`` address or a
``torch.distributed.FileStore``, with the world size and this rank.

    from libfluid_tpu_torch.parallel import distributed, zshard
    distributed.init_distributed("tcp://127.0.0.1:29500", 1, 0)   # NCCL
    mesh = distributed.global_mesh(("dp",))
    st = zshard.zshard_state(state, cfg, mesh)
    st, diag = zshard.substep_z(st, cfg, dt, mesh)
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from libfluid_tpu_torch.parallel.mesh import RankMesh, make_mesh


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "nccl",
    store=None,
    timeout: Optional[float] = None,
) -> None:
    """Join (or start) the process group. Idempotent: a second call is a
    no-op. The rendezvous is `coordinator_address` (``tcp://host:port``,
    or ``host:port``) or `store`; without either, the ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` environment. `backend`
    "nccl" (the default: CUDA tensors) raises without a CUDA card or an
    NCCL build; it never drops to gloo. `timeout` in seconds bounds every
    collective."""
    if dist.is_initialized():
        return
    if backend == "nccl" and not (torch.cuda.is_available() and dist.is_nccl_available()):
        raise RuntimeError(
            "init_distributed: the NCCL backend needs a CUDA card and an NCCL build of torch; "
            'pass backend="gloo" for CPU tensors'
        )
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"init_distributed: backend {backend!r}, expected 'nccl' or 'gloo'")
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    if store is not None:
        kwargs.update(store=store, world_size=num_processes, rank=process_id)
    elif coordinator_address is not None:
        addr = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        kwargs.update(init_method=addr, world_size=num_processes, rank=process_id)
    else:
        kwargs.update(init_method="env://")
    dist.init_process_group(backend, **kwargs)


def global_mesh(
    axis_names: Sequence[str] = ("dp",), axis_sizes: Optional[Sequence[int]] = None, device=None
) -> RankMesh:
    """The mesh of all ranks, in rank order (a 1-D 'dp' axis keeps
    neighbouring z-slabs on neighbouring ranks). `device` as in
    :func:`~libfluid_tpu_torch.parallel.mesh.make_mesh`."""
    n = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(f"axis sizes {tuple(axis_sizes)} != {n} ranks")
    return make_mesh(n, axis_names, device=device)


def process_count() -> int:
    return dist.get_world_size()


def is_coordinator() -> bool:
    return dist.get_rank() == 0
