"""The readings that the limits of ``correct`` are set from, on the card:

    python portbench/readings.py --workload dam128.frames --seeds 1 2 ... 12 --control-seeds 101 102 103

For each of ``--seeds``, a run of the cell whose window is one episode
prints every number that the comparison with the reference gives of the
program; for each of
``--control-seeds`` the same with the control (``reference/control.py``:
the reference with its state in bfloat16) in the program's place on the
compared frames. One process, one program. The last line is a JSON object:
for each number, the largest reading of the program and the smallest of
the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    os.environ["LIBFLUID_CACHE_DIR"] = str(ROOT / "portbench" / ".cache")
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness
    from portbench.reference.control import Control
    from portbench.system import Program

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    bench = harness.Bench(ROOT)
    program = Program("cuda")
    readings = {"program": {}, "control": {}}
    for side, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            control = Control("cuda") if side == "control" else None
            _, _, numbers = harness.run_cell(bench, args.workload, seed, 0.0, False, device="cuda",
                                             system=program, control=control)
            print(json.dumps({"side": side, "seed": seed, "numbers": numbers}), flush=True)
            for name, value in numbers.items():
                readings[side].setdefault(name, []).append(value)
    print(json.dumps({
        "workload": args.workload,
        "program_largest": {k: max(v) for k, v in readings["program"].items()},
        "control_smallest": {k: min(v) for k, v in readings["control"].items()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
