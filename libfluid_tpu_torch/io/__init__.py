"""Host-side I/O: meshes, point clouds and images (numpy copies of
``libfluid_tpu.io.obj``, ``libfluid_tpu.io.point_cloud`` and
``libfluid_tpu.io.ppm``; importing the JAX package's ``io`` would import
JAX)."""

from libfluid_tpu_torch.io.obj import save_obj
from libfluid_tpu_torch.io.point_cloud import save_points, load_points
from libfluid_tpu_torch.io.ppm import save_ppm

__all__ = ["save_obj", "save_points", "load_points", "save_ppm"]
