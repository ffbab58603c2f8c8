"""PyTorch + CUDA port of ``libfluid_tpu`` for NVIDIA Hopper (H100).

The JAX package ``libfluid_tpu`` is the reference: each module here mirrors
its counterpart there and is tested against it on the same inputs. Plain
tensor code is PyTorch; the kernels of the hot path are CUDA C++ in
``csrc/``, built at first use by :mod:`libfluid_tpu_torch._build`. This
package never imports ``jax``.
"""

from libfluid_tpu_torch.config import (
    CellType, MesherConfig, RenderConfig, SimConfig, SolverConfig, TransferScheme,
)

__all__ = ["CellType", "MesherConfig", "RenderConfig", "SimConfig", "SolverConfig", "TransferScheme"]
