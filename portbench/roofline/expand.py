"""Kernel A, ``expand`` (``csrc/expand.cu``, ``slotsort.expand``): the slot
payload ``out[:, j] = payT[:, ins[j]]`` where cell ``j % num_c`` holds more
than ``j // num_c`` particles, else 0.

Bytes: the payload written, ``ins`` and ``counts`` read, and the payload
rows of the slots that hold a particle. No arithmetic to speak of.
Launch: ``(payT, ins, counts, out, ncols, k, num_c)``.
"""

SYMBOL, BF16 = "expand_kernel", False


def measure(args) -> dict:
    pay, ins, counts, out, _, k, _ = args
    return {"out": out.numel() * 4, "ins": ins.numel() * 4, "counts": counts.numel() * 4,
            "rows": pay.shape[0], "filled": int(counts.clamp(max=k).sum())}


def cost(m: dict):
    return m["out"] + m["ins"] + m["counts"] + 4 * m["rows"] * m["filled"], 0.0
