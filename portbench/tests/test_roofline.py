"""The roofline table (``portbench/roofline/``) held to the 128^3 figures
that ``PERF.md`` gives for each kernel (bytes over 3.35 TB/s or float32
operations over 67 TFLOP/s), and each file's reading of a launch's own
arguments at a small size."""

import ctypes
import math

import pytest
import torch

from portbench import harness, peaks
from conftest import ROOT

N = 128
CELL = N ** 3
FACE = (N + 1) * N * N  # one face array
COARSE = (N // 2) ** 3
PARTICLES = 2_000_376  # the seed box (1, 1, 1) + (63, 63, 63) at 2 a cell an axis
SLOTS = 12 * CELL


def _level(n, size):
    return 3 * n ** 3 * size, 3 * (n + 1) * n * n * size


def _vcycle(size):
    cells, faces = _level(N, size)
    a = CELL * size
    return {
        "pre": {"bytes": 2 * a + cells + faces, "cells": CELL},
        "restrict": {"bytes": 2 * a + a + a + faces + 2 * COARSE * size, "cells": CELL},
        "up": {"bytes": 3 * a + COARSE * size + cells + faces, "cells": CELL},
        "coarse": {"bytes": (2 * 16 ** 3 + sum(sum(_level(n, 1)) for n in (16, 8))) * size,
                   "cells": 16 ** 3 + 8 ** 3},
    }


F32, BF16 = _vcycle(4), _vcycle(2)
# kernel -> (its counts at 128^3 with 2,000,376 particles, the bound PERF.md gives in ms)
FIGURES = {
    "expand": ({"out": 16 * SLOTS * 4, "ins": SLOTS * 4, "counts": CELL * 4, "rows": 16,
                "filled": PARTICLES}, "0.552"),
    "p2g": ({"mask": SLOTS * 4, "rows": 16, "occupied": PARTICLES, "faces": 6 * FACE * 4}, "0.081"),
    "stencil": ({"bytes": 6 * CELL * 4 + 3 * FACE * 4, "cells": CELL}, "0.0226"),
    "stencil16": ({"bytes": 6 * CELL * 2 + 3 * FACE * 2, "cells": CELL}, "0.0113"),
    "mg_pre": (F32["pre"], "0.0201"),
    "mg_restrict": (F32["restrict"], "0.0182"),
    "mg_up": (F32["up"], "0.0229"),
    "mg_coarse": (F32["coarse"], "0.00004"),
    "mg16_pre": (BF16["pre"], "0.0100"),
    "mg16_restrict": (BF16["restrict"], "0.0091"),
    "mg16_up": (BF16["up"], "0.0115"),
    "mg16_coarse": (BF16["coarse"], "0.00002"),
    "g2p": ({"faces": 3 * FACE * 4, "particles": PARTICLES}, "0.043"),
    # the pairs of the state PERF.md measured fall under the bytes' bound
    "correction": ({"mask": SLOTS * 4, "out": 3 * SLOTS * 4, "occupied": PARTICLES, "pairs": 3.0e8}, "0.127"),
    "surface": ({"out": 261 ** 3 * 4, "particles": PARTICLES, "reach": 4.0 / 3.0 * math.pi * 4.0 ** 3},
                "0.168"),
}


def table():
    return harness.Bench(ROOT).roofline()


def test_every_kernel_of_the_table_has_its_figure():
    assert set(table()) == set(FIGURES)


@pytest.mark.parametrize("kernel", sorted(FIGURES))
def test_bound_at_128_matches_perf_md(kernel):
    counts, figure = FIGURES[kernel]
    bound_ms = 1e3 * peaks.bound_s(*table()[kernel].cost(counts))
    digits = len(figure.split(".")[1])
    assert f"{bound_ms:.{digits}f}" == figure


def _small_launch(kernel):
    """Arguments of one launch of `kernel` at 6 x 5 x 4 cells, as its
    wrapper passes them to ``kernels.launch``, and the expected counts."""
    g = torch.Generator().manual_seed(0)
    nx, ny, nz = 6, 5, 4
    cells = nx * ny * nz
    bf = kernel.startswith("mg16") or kernel == "stencil16"
    dt = torch.bfloat16 if bf else torch.float32
    size = 2 if bf else 4
    level = [torch.rand((nx, ny, nz), generator=g).to(dt) for _ in range(3)] + [
        torch.rand(s, generator=g).to(dt) for s in ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))]
    level_bytes = sum(t.numel() for t in level) * size
    x = torch.rand((nx, ny, nz), generator=g).to(dt)
    coarse = torch.zeros((3, 3, 2), dtype=dt)
    if kernel in ("stencil", "stencil16"):
        args = [x, x.clone(), *level, x.clone(), nx, ny, nz, 1, 0.8, 1.0]  # Jacobi mode
        return args, {"bytes": 3 * cells * size + level_bytes, "cells": cells}
    if kernel.endswith("_pre"):
        return [x, *level, x.clone(), nx, ny, nz, 0.8, 1.0], {"bytes": 2 * cells * size + level_bytes,
                                                              "cells": cells}
    if kernel.endswith("_restrict"):
        args = [x, x.clone(), *level, coarse, coarse.clone(), nx, ny, nz, 1.0]
        return args, {"bytes": 2 * cells * size + level_bytes - cells * size + 2 * coarse.numel() * size,
                      "cells": cells}
    if kernel.endswith("_up"):
        args = [x, coarse, x.clone(), *level, x.clone(), nx, ny, nz, 0.8, 1.0]
        return args, {"bytes": 3 * cells * size + coarse.numel() * size + level_bytes, "cells": cells}
    if kernel.endswith("_coarse"):
        dims = (ctypes.c_int * 6)(nx, ny, nz, 3, 3, 2)
        lv2 = 3 * 18 + 4 * 3 * 2 + 3 * 4 * 2 + 3 * 3 * 3
        args = [x, None, dims, None, 2, None, x.clone(), 2, 2, 12, 0.8, 0]
        return args, {"bytes": (2 * cells + level_bytes // size + lv2) * size, "cells": cells + 18}
    k = 3
    if kernel == "expand":
        counts = torch.tensor([0, 1, 5, 2] * 30, dtype=torch.int32)
        out = torch.zeros((16, k * 120))
        args = [torch.rand((16, 50), generator=g), torch.zeros(k * 120, dtype=torch.int32), counts, out,
                50, k, 120]
        return args, {"out": out.numel() * 4, "ins": k * 120 * 4, "counts": 120 * 4, "rows": 16,
                      "filled": 30 * (0 + 1 + 3 + 2)}
    if kernel == "p2g":
        data = torch.zeros((16, k, nx, ny, nz))
        data[3, 0, :3] = 1.0
        faces = [torch.zeros(s) for s in ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))] * 2
        args = [data, *faces, k, nx, ny, nz, 1.0, 0.0, 0.0, 0.0, 1]
        return args, {"mask": k * cells * 4, "rows": 16, "occupied": 3 * ny * nz,
                      "faces": sum(f.numel() for f in faces) * 4}
    if kernel == "g2p":
        faces = [torch.zeros(s) for s in ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))]
        pos = torch.rand((10, 3), generator=g)
        return [*faces, pos, torch.zeros(10, 3), torch.zeros(10, 3, 3), 10, nx, ny, nz, 1.0, 0.0, 0.0, 0.0], {
            "faces": sum(f.numel() for f in faces) * 4, "particles": 10}
    if kernel == "correction":
        mask = torch.zeros((k, nx, ny, nz))
        mask[0, 2, 2, 2] = mask[1, 2, 2, 2] = mask[0, 3, 2, 2] = 1.0
        out = torch.zeros((3, k, nx, ny, nz))
        args = [torch.zeros((3, k, nx, ny, nz)), mask, out, k, nx, ny, nz, 0.5, 7, 0, 0, 0]
        # the two particles of cell (2, 2, 2) see each other and the third; the third sees both
        return args, {"mask": mask.numel() * 4, "out": out.numel() * 4, "occupied": 3, "pairs": 6.0}
    if kernel == "surface":
        out = torch.zeros((nx + 1, ny + 1, nz + 1))
        starts = torch.tensor([0, 4, 9], dtype=torch.int32)
        args = [torch.zeros((12, 3)), starts, out, nx, ny, nz, 4, 0.5, 0.0, 0.0, 0.0, 4.0, 0.5]
        return args, {"out": out.numel() * 4, "particles": 9, "reach": 4.0 / 3.0 * math.pi * 4.0 ** 3}
    raise KeyError(kernel)


@pytest.mark.parametrize("kernel", sorted(FIGURES))
def test_counts_read_from_a_launch(kernel):
    args, want = _small_launch(kernel)
    got = table()[kernel].measure(args)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-6), key


def test_an_unknown_hand_kernel_counts_with_a_bound_of_zero():
    tab = table()
    prof = {"kernels": [
        {"name": "void p2g_kernel(float const*)", "s": 1e-3, "hand": True},
        {"name": "void new_kernel(float*)", "s": 3e-3, "hand": True},
        {"name": "void at::native::add_kernel(float*)", "s": 5e-3, "hand": False},
    ], "bounds": {"p2g": [0.5e-3, 0.5e-3]}}
    recs = harness.roofline(prof, tab)
    assert recs["p2g"] == {"s": 1e-3, "n": 1, "bound_s": 0.5e-3}
    unknown = [r for name, r in recs.items() if name.startswith("unknown")]
    assert len(unknown) == 1 and unknown[0]["bound_s"] == 0.0 and unknown[0]["s"] == 3e-3
    assert len(recs) == 2
