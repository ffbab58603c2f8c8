"""Math substrate (port of ``libfluid_tpu.math``): interpolation, affine
transforms, sample warping and intersection tests on tensors with a
trailing axis of size 3, batched over leading axes."""

from libfluid_tpu_torch.math.interp import lerp, bilerp, trilerp
from libfluid_tpu_torch.math import transforms, warping, intersection

__all__ = ["lerp", "bilerp", "trilerp", "transforms", "warping", "intersection"]
