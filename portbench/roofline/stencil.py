"""Kernel C, ``stencil`` (``csrc/stencil.cu``, ``multigrid.stencil``): one pass of the masked
7-point operator in one of three modes.

Bytes: x, the output, the diagonal, the fluid mask and the three face
couplings; b as well in the Jacobi and residual modes, and the inverse
diagonal in the Jacobi mode (the apply mode, the CG operator, reads
neither). Operations: ~20 a cell. Launch: ``(x, b, diag, inv_diag, fluid,
cu, cv, cw, out, nx, ny, nz, mode, damp, scale)``.
"""

SYMBOL, BF16 = "stencil_kernel", False
APPLY, JACOBI = 0, 1


def measure(args) -> dict:
    x, b, diag, inv_diag, fluid, cu, cv, cw, out = args[:9]
    mode = args[12]
    read = [x, out, diag, fluid, cu, cv, cw]
    if mode != APPLY:
        read.append(b)
    if mode == JACOBI:
        read.append(inv_diag)
    return {"bytes": sum(t.numel() * t.element_size() for t in read), "cells": x.numel()}


def cost(m: dict):
    return m["bytes"], 20.0 * m["cells"]
