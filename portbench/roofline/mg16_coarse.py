"""``mg16_coarse`` (``csrc/vcycle.cu``, ``multigrid.coarse_cycle`` in bfloat16): the
whole sub-cycle of the small levels in one block.

Bytes: b and the output, each level's six arrays. Operations: ~40 a cell
a pass, six passes. What bounds it is neither: the cycle's dependent
passes on one multiprocessor. Launch: ``(b, level pointers, level dims,
scales, levels, scratch, out, pre, post, coarse_iters, damp, smem)``.
"""

SYMBOL, BF16 = "mg_coarse_kernel", True


def measure(args) -> dict:
    b, dims, n_levels, out = args[0], list(args[2]), args[4], args[6]
    arrays = 0
    cells = 0
    for lv in range(n_levels):
        nx, ny, nz = dims[3 * lv:3 * lv + 3]
        n = nx * ny * nz
        cells += n
        arrays += 3 * n + (nx + 1) * ny * nz + nx * (ny + 1) * nz + nx * ny * (nz + 1)
    size = b.element_size()
    return {"bytes": (b.numel() + out.numel() + arrays) * size, "cells": cells}


def cost(m: dict):
    return m["bytes"], 40.0 * m["cells"] * 6
