"""``mg_up`` (``csrc/vcycle.cu``, ``multigrid.prolong_smooth``): the
coarse correction prolonged onto one level and the post-sweeps.

Bytes: x, the coarse correction, b, the output and the level's six arrays.
Operations: ~60 a cell. Launch: ``(x, ec, b, diag, inv_diag, fluid, cu,
cv, cw, out, nx, ny, nz, damp, scale)``.
"""

SYMBOL, BF16 = "mg_up_kernel", False


def measure(args) -> dict:
    return {"bytes": sum(t.numel() * t.element_size() for t in args[:10]), "cells": args[2].numel()}


def cost(m: dict):
    return m["bytes"], 60.0 * m["cells"]
