"""``mg_restrict`` (``csrc/vcycle.cu``, ``multigrid.restrict_residual``):
the residual b - A x on one level, restricted to the next.

Bytes: x, b, the diagonal, the fluid mask and the three couplings, the
coarse fluid mask, the coarse right-hand side written (the residual reads
no inverse diagonal). Operations: ~40 a fine cell. Launch: ``(x, b, diag,
inv_diag, fluid, cu, cv, cw, fluid_c, rc, nx, ny, nz, scale)``.
"""

SYMBOL, BF16 = "mg_restrict_march", False


def measure(args) -> dict:
    x, b, diag, _, fluid, cu, cv, cw, fluid_c, rc = args[:10]
    read = (x, b, diag, fluid, cu, cv, cw, fluid_c, rc)
    return {"bytes": sum(t.numel() * t.element_size() for t in read), "cells": b.numel()}


def cost(m: dict):
    return m["bytes"], 40.0 * m["cells"]
