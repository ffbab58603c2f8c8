"""Halo exchange for z-sharded grid tiles, and a sharded Poisson stencil
(port of ``libfluid_tpu.parallel.halo``).

The ±1 ring of the JAX package's ``lax.ppermute`` is one batch of
point-to-point sends and receives (``dist.batch_isend_irecv``); a dot
product is a local sum and one ``all_reduce``. The ring wraps around as
the JAX package's does (rank n-1 sends up to rank 0), and the callers mask
the domain ends; on a mesh of one rank the ring is a copy (a rank sends its
layers to itself), while the collectives go through the backend at any
size.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from libfluid_tpu_torch.parallel.mesh import RankMesh


def ring(send_up: torch.Tensor, send_down: torch.Tensor, mesh: RankMesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each rank sends `send_up` to rank + 1 and `send_down` to rank - 1
    (mod size); returns (what rank - 1 sent up, what rank + 1 sent down)."""
    if mesh.size == 1:
        return send_up.clone(), send_down.clone()
    up = mesh.peer((mesh.rank + 1) % mesh.size)
    down = mesh.peer((mesh.rank - 1) % mesh.size)
    send_up, send_down = send_up.contiguous(), send_down.contiguous()
    from_below = torch.empty_like(send_up)
    from_above = torch.empty_like(send_down)
    # with two ranks both messages go to the same peer: the tags (gloo) and
    # the same order of the operations on every rank (NCCL) pair them
    ops = [
        dist.P2POp(dist.isend, send_up, up, mesh.group, tag=0),
        dist.P2POp(dist.isend, send_down, down, mesh.group, tag=1),
        dist.P2POp(dist.irecv, from_below, down, mesh.group, tag=0),
        dist.P2POp(dist.irecv, from_above, up, mesh.group, tag=1),
    ]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return from_below, from_above


def halo_exchange_z(x: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """Pad a local (nx, ny, nz_local, ...) tile with one ghost layer from
    each z-neighbour (zero at the domain ends): (nx, ny, nz_local+2, ...)."""
    from_below, from_above = ring(x[:, :, -1:], x[:, :, :1], mesh)
    left = torch.zeros_like(from_below) if mesh.rank == 0 else from_below
    right = torch.zeros_like(from_above) if mesh.rank == mesh.size - 1 else from_above
    return torch.cat([left, x, right], dim=2)


def sharded_apply_A(fluid, couple_w_lo, couple_w_hi, couple_u, couple_v, diag, p, a_scale, mesh: RankMesh):
    """Masked 7-point Laplacian on a z-sharded tile: the operator of
    ``pressure.apply_A``, the z-neighbour terms through the halo.
    `couple_w_lo/hi` are the local cell's couplings to its -z/+z
    neighbour."""
    p = p * fluid
    ph = halo_exchange_z(p, mesh)
    nbr = (
        couple_u[:-1] * F.pad(p, (0, 0, 0, 0, 1, 0))[:-1]
        + couple_u[1:] * F.pad(p, (0, 0, 0, 0, 0, 1))[1:]
        + couple_v[:, :-1] * F.pad(p, (0, 0, 1, 0))[:, :-1]
        + couple_v[:, 1:] * F.pad(p, (0, 0, 0, 1))[:, 1:]
        + couple_w_lo * ph[:, :, :-2]
        + couple_w_hi * ph[:, :, 2:]
    )
    return a_scale * (diag * p - nbr) * fluid


def all_sum(x: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """The sum of `x` over the ranks (the JAX package's ``psum``)."""
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


def all_max(x: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """The maximum of `x` over the ranks (``pmax``)."""
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.group)
    return x


def all_gather(x: torch.Tensor, mesh: RankMesh, dim: int) -> torch.Tensor:
    """The ranks' tensors (of one shape) concatenated along `dim` in rank
    order (``all_gather(..., tiled=True)``)."""
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=dim)


def sharded_dot(a: torch.Tensor, b: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """Global inner product across tiles: one ``all_reduce``."""
    return all_sum(torch.sum(a * b), mesh)
