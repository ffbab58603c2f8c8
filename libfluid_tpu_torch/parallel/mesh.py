"""Rank meshes and layout descriptors (port of ``libfluid_tpu.parallel.mesh``).

The JAX package's ``Mesh`` is a set of devices that one program spans; its
``NamedSharding`` says how a global array is laid over them. Here each rank
is a process of ``torch.distributed`` with one device, and a mesh is the
rank group a collective runs over (:class:`RankMesh`). There is no global
array: a layout (:class:`Layout`) says which block of a global tensor a rank
holds, and :meth:`Layout.local` cuts it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from libfluid_tpu_torch.config import resolve_device


class RankMesh(NamedTuple):
    """A 1-D group of ranks, one device each: ``size`` ranks, this process
    at ``rank``, its tensors on ``device``."""

    group: Optional[dist.ProcessGroup]  # None: the default group
    axis_names: Tuple[str, ...]
    size: int
    rank: int
    device: torch.device

    def peer(self, rank: int) -> int:
        """The global rank of group rank `rank` (what point-to-point calls take)."""
        if self.group is None:
            return rank
        return dist.get_global_rank(self.group, rank)


def make_mesh(
    n_devices: Optional[int] = None, axis_names: Sequence[str] = ("dp",), device=None, group=None
) -> RankMesh:
    """The mesh of the ranks of `group` (default: all), this process's
    tensors on `device` (None: the CUDA card; ``"cpu"`` on request). The
    group's backend must suit the device: NCCL for CUDA tensors, gloo for
    CPU tensors. `n_devices`, if given, must equal the group's size (one
    device a rank)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialized (parallel.distributed.init_distributed)")
    device = resolve_device(device)
    backend = dist.get_backend(group)
    want = "nccl" if device.type == "cuda" else "gloo"
    if backend != want:
        raise RuntimeError(f"make_mesh: {device.type} tensors need the {want} backend, the group has {backend}")
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, the group has {size} ranks")
    return RankMesh(group, tuple(axis_names), size, dist.get_rank(group), device)


class Layout(NamedTuple):
    """What a rank holds of a global tensor: block ``mesh.rank`` of ``size``
    equal blocks along ``dim``, or all of it (``dim`` None)."""

    mesh: RankMesh
    dim: Optional[int]

    def local(self, x: torch.Tensor) -> torch.Tensor:
        if self.dim is None:
            return x
        n = x.shape[self.dim]
        if n % self.mesh.size != 0:
            raise ValueError(f"dimension {self.dim} of {tuple(x.shape)} does not split over {self.mesh.size} ranks")
        return torch.chunk(x, self.mesh.size, dim=self.dim)[self.mesh.rank]


def particle_sharding(mesh: RankMesh) -> Layout:
    """Rows of the leading (particle or ray) axis."""
    return Layout(mesh, 0)


def replicated(mesh: RankMesh) -> Layout:
    return Layout(mesh, None)


def grid_sharding_z(mesh: RankMesh) -> Layout:
    """z-tiles of an (nx, ny, nz) grid: the layout of the halo stencils."""
    return Layout(mesh, 2)
