"""Kernel F, ``surface`` (``csrc/surface.cu``, ``surface.sample_surface``):
the mesher's node values from the binned particles.

Bytes: the node values written, the binned particles' positions.
Operations: each particle weighs on the nodes within its extent (a ball of
(extent / h)^3 4/3 pi nodes), ~21 operations a pair. Launch: ``(pos_s,
starts, out, nx, ny, nz, cr, h, ox, oy, oz, extent^2, radius)``.
"""

import math

SYMBOL, BF16 = "surface_kernel", False


def measure(args) -> dict:
    starts, out, h, ext2 = args[1], args[2], args[7], args[11]
    return {"out": out.numel() * 4, "particles": int(starts[-1]), "reach": 4.0 / 3.0 * math.pi
            * (math.sqrt(ext2) / h) ** 3}


def cost(m: dict):
    return m["out"] + 12 * m["particles"], 21.0 * m["reach"] * m["particles"]
