"""Kernel D, ``g2p`` (``csrc/g2p.cu``, ``transfers.g2p_pic``): every
particle's velocity and APIC matrix from the face velocities.

Bytes: the three face arrays, and for each particle row the launch takes
its position read and its velocity and matrix written (12 + 12 + 36).
Operations: 54 face samples, ~8 operations each. Launch: ``(u, v, w,
position, velocity, affine, n, nx, ny, nz, h, ox, oy, oz)``.
"""

SYMBOL, BF16 = "g2p_kernel", False


def measure(args) -> dict:
    u, v, w, pos = args[:4]
    return {"faces": (u.numel() + v.numel() + w.numel()) * 4, "particles": pos.shape[0]}


def cost(m: dict):
    return m["faces"] + 60 * m["particles"], 54 * 8.0 * m["particles"]
