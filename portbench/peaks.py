"""The published peaks of one NVIDIA H100 (SXM, 80 GB HBM3; NVIDIA's data
sheet, dense rates, at the full power limit of 700 W), against which a
kernel's roofline share is stated."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12  # float32 outside the tensor cores


def bound_s(moved_bytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    return max(moved_bytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)
