"""A check of the card's bfloat16 arithmetic, beside the build of the kernels.

The bfloat16 kernels "mg16_pre" and "mg16_restrict" (``csrc/vcycle.cu``)
take the card's bfloat16 multiply, add and subtract where the plain stages
round a float32 result once. :func:`rounding_check` runs
``csrc/bf16_check.cu`` over every ordered pair of bfloat16 bit patterns and
counts where they differ. It is not a stage of the solver: it has no plain
version and counts no launch.
"""

import torch

from libfluid_tpu_torch import _build

# The operations of lf_bf16_check's counts, in their order: the scalar forms
# and their paired forms; and those the kernels use.
CHECK_OPS = ("hmul", "hadd", "hsub", "hmul2", "hadd2", "hsub2")
KERNEL_OPS = ("hmul", "hadd", "hsub")


def rounding_check(device=None) -> dict:
    """The card's bfloat16 multiply, add and subtract, and their paired
    forms, against one rounding of the float32 result over every ordered
    pair of bfloat16 bit patterns: the count of mismatches of each operation
    (a NaN matches any NaN), keyed by ``CHECK_OPS``. Without a CUDA device it
    raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise RuntimeError(f"the bfloat16 check runs on a CUDA device, got {device}")
    counts = torch.zeros(len(CHECK_OPS), dtype=torch.int64, device=device)
    err = _build.load().lf_bf16_check(counts.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bf16_check kernel (lf_bf16_check) failed: CUDA error {err}")
    return dict(zip(CHECK_OPS, counts.tolist()))
