"""Where to cut the fused V-cycle: which levels the one-block kernel takes.

Times ``multigrid.v_cycle`` on the 128^3 dam-break's levels with the small
levels' kernel ("mg_coarse") starting at 32^3, 16^3 or 8^3, each against the
plain cycle, and prints the launches of a cycle.

Run from the repository root on a machine with an H100:

    python3 tools/vcycle_cut.py
"""

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from libfluid_tpu_torch import sim  # noqa: E402
from libfluid_tpu_torch.sim import kernels, multigrid, pressure  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("vcycle_cut.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    cfg, state = cs.dam_break(128, torch.device("cuda"), 1 << 21)
    state, _ = sim.substep(state, cfg, cs.DT)
    levels = multigrid.build_levels(state.grid.cell_type)
    b = pressure.compute_rhs(state.grid, cfg)
    want = multigrid._coarse_torch(levels, b, 0)
    built = multigrid._COARSE_CELLS
    for turn in range(2):
        for side in (32, 16, 8):
            multigrid._COARSE_CELLS = side ** 3
            kernels.reset_launches()
            got = multigrid.v_cycle(levels, b)
            launches = sum(kernels.LAUNCHES.values())
            coarse = levels[multigrid.first_coarse_level(levels)].fluid
            print(f"turn {turn}, one block from {side}^3 down{' (as built)' if side ** 3 == built else ''}: "
                  f"{launches} launches, error against the plain cycle {cs.max_err(got, want):.3e}, "
                  f"cycle {cs.median_ms(lambda: multigrid.v_cycle(levels, b)):.4f} ms device, "
                  f"{cs.wall_ms(lambda: multigrid.v_cycle(levels, b)):.4f} ms host clock, mg_coarse alone "
                  f"{cs.median_ms(lambda: multigrid.coarse_cycle(levels, torch.ones_like(coarse), multigrid.first_coarse_level(levels))):.4f} ms",
                  flush=True)
    multigrid._COARSE_CELLS = built


if __name__ == "__main__":
    main()
