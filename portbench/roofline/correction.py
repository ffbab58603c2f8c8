"""Kernel E, ``correction`` (``csrc/correction.cu``,
``correction._springs``): the position-correction springs of the resident
slots.

Bytes: the slot mask, the springs written, the positions of the occupied
slots. Operations: ~20 for each ordered pair of particles in neighbouring
cells. Launch: ``(res_pos, res_mask, out, kc, nx, ny, nz, re2, seed, ox,
oy, oz)``.
"""

import torch

SYMBOL, BF16 = "correction_kernel", False


def measure(args) -> dict:
    mask, out = args[1], args[2]
    per_cell = (mask != 0).sum(0, dtype=torch.float32)
    around = 27.0 * torch.nn.functional.avg_pool3d(per_cell[None, None], 3, 1, 1)[0, 0]
    return {"mask": mask.numel() * 4, "out": out.numel() * 4, "occupied": int(per_cell.sum()),
            "pairs": float((per_cell * (around - 1.0)).sum())}


def cost(m: dict):
    return m["mask"] + m["out"] + 12 * m["occupied"], 20.0 * m["pairs"]
