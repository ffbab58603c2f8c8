"""Surface meshing: particles -> implicit surface -> triangle mesh (port of
``libfluid_tpu.mesher``)."""

from libfluid_tpu_torch.mesher.surface import sample_surface
from libfluid_tpu_torch.mesher.marching_cubes import marching_cubes, MeshBuffers, generate_mesh

__all__ = ["sample_surface", "marching_cubes", "MeshBuffers", "generate_mesh"]
