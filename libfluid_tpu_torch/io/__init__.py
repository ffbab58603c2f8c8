"""Host-side I/O: meshes and point clouds (numpy copies of
``libfluid_tpu.io.obj`` and ``libfluid_tpu.io.point_cloud``; importing the
JAX package's ``io`` would import JAX)."""

from libfluid_tpu_torch.io.obj import save_obj
from libfluid_tpu_torch.io.point_cloud import save_points, load_points

__all__ = ["save_obj", "save_points", "load_points"]
