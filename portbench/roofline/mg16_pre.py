"""``mg16_pre`` (``csrc/vcycle.cu``, ``multigrid.pre_smooth`` in bfloat16): the
V-cycle's pre-sweeps from x = 0 on one level.

Bytes: b and the output, the level's six arrays (diagonal, inverse
diagonal, fluid mask, three couplings). Operations: ~40 a cell. Launch:
``(b, diag, inv_diag, fluid, cu, cv, cw, out, nx, ny, nz, damp, scale)``.
"""

SYMBOL, BF16 = "mg_pre_march", True


def measure(args) -> dict:
    return {"bytes": sum(t.numel() * t.element_size() for t in args[:8]), "cells": args[0].numel()}


def cost(m: dict):
    return m["bytes"], 40.0 * m["cells"]
