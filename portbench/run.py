"""Run one cell of the benchmark of ``libfluid_tpu_torch`` on the CUDA card.

    python portbench/run.py --workload dam128.frames --seed 7 --seconds 30 --trace 0

Run from the root of a checkout. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
and, with ``--trace 1``, ``breakdown``); the numbers that decide ``correct``
are the last lines of standard error and the last key of that object. The
run exits with another code than 0, and prints no result, without a CUDA
card, with fewer cards than the cell asks for, or if ``jax``, ``jaxlib``,
``flax`` or ``libfluid_tpu`` was loaded. The port's kernel library is kept
in ``portbench/.cache/`` (``LIBFLUID_CACHE_DIR``), so only the first run in
a checkout builds it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE_DIR = ROOT / "portbench" / ".cache"
# top-level module names that may not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "libfluid_tpu")


def process_start() -> float:
    """The wall-clock time this process started, from /proc (10 ms ticks);
    now where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["LIBFLUID_CACHE_DIR"] = str(CACHE_DIR)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    bench = harness.Bench(ROOT)
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2
    result, checks, _ = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                                      device="cuda", t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"modules that the benchmark may not load were loaded: {found}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
