"""Kernel B, ``p2g`` (``csrc/p2g.cu``, ``kernels.p2g_faces``): the
unnormalised face sums of the slot payload.

Bytes: the mask row of every slot, the other rows of the occupied slots,
the six face arrays written. Operations: an occupied slot reaches at most
54 faces, ~12 operations each. Launch: ``(data, 3 numerators, 3
denominators, k, nx, ny, nz, h, ox, oy, oz, apic)``.
"""

SYMBOL, BF16 = "p2g_kernel", False


def measure(args) -> dict:
    data, faces = args[0], args[1:7]
    return {"mask": data[3].numel() * 4, "rows": data.shape[0], "occupied": int((data[3] != 0).sum()),
            "faces": sum(f.numel() * 4 for f in faces)}


def cost(m: dict):
    return m["mask"] + 4 * (m["rows"] - 1) * m["occupied"] + m["faces"], 54 * 12.0 * m["occupied"]
