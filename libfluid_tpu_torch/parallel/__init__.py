"""Multi-rank scaling on ``torch.distributed`` (port of
``libfluid_tpu.parallel``): one process per device, NCCL between CUDA
ranks and gloo between CPU ranks.

- the z-sharded substep (:mod:`.zshard`): particles owned by the rank of
  their z-slab, exchanged over a ±1 ring; the grid in z-tiles with width-1
  halos; the pressure MG-PCG with ``all_reduce`` dot products;
- camera rays split over the ranks for rendering, the image gathered;
- gradients of a pixel loss summed with ``all_reduce``.
"""

from libfluid_tpu_torch.parallel.mesh import make_mesh, particle_sharding, replicated
from libfluid_tpu_torch.parallel.halo import halo_exchange_z, sharded_apply_A
from libfluid_tpu_torch.parallel.shard import shard_sim_state, sharded_render, sharded_substep, training_step
from libfluid_tpu_torch.parallel.zshard import gather_state, step_z, substep_z, zshard_state

__all__ = [
    "make_mesh",
    "particle_sharding",
    "replicated",
    "halo_exchange_z",
    "sharded_apply_A",
    "shard_sim_state",
    "sharded_substep",
    "sharded_render",
    "training_step",
    "substep_z",
    "step_z",
    "zshard_state",
    "gather_state",
]
