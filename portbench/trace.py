"""Reading ``torch.profiler``'s trace of a few replayed frames: the device's
busy time, its idle gaps and what the host did in them, the host's reads
of device values, the device operations that took the most time, and each
device kernel's place in the program (the module of the deepest frame of
``libfluid_tpu_torch/sim/*.py`` on the Python stack that launched it).

The trace is the profiler's Chrome trace (``export_chrome_trace``), read
back as JSON: its events carry a category (``cpu_op``, ``python_function``,
``cuda_runtime``/``cuda_driver`` for the host side of a launch, ``kernel``,
``gpu_memcpy``, ``gpu_memset`` for the device side), a start and a length in
microseconds, and a correlation id that joins a launch to its kernel.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SIM = "libfluid_tpu_torch/sim/"
DISPATCH = SIM + "kernels.py"  # the kernels' dispatch: a kernel is placed with its caller
SYNC_OP = "aten::_local_scalar_dense"  # a read of one device value by the host
_FRAME = re.compile(r"^(.*)\((\d+)\): (.*)$")


def events_of(prof) -> list:
    """The events of a finished ``torch.profiler.profile``."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _spans(events, cats):
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e) for e in events
            if e.get("cat") in cats and e.get("ph") == "X"]


def merge(intervals):
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def stacks(intervals, times):
    """For each of the sorted `times`, the payloads of the nested
    (start, end, payload) `intervals` that contain it, outermost first."""
    spans = sorted(intervals, key=lambda s: (s[0], -s[1]))
    stack, i, out = [], 0, []
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append([p for _, _, p in stack])
    return out


def summary(events, top: int = 10) -> dict:
    """The device's busy seconds (the union of its operations), the host's
    reads of device values, the device operations with the most time, and
    the idle gaps between device operations by the CPU operation running
    at each gap's middle ("python" where none was), the most idle time
    first."""
    dev = _spans(events, DEVICE_CATS)
    busy = merge([(a, b) for a, b, _ in dev])
    by_name = defaultdict(float)
    for a, b, e in dev:
        by_name[e["name"]] += (b - a) * 1e-6
    cpu = _spans(events, ("cpu_op",))
    per_tid = defaultdict(list)
    for a, b, e in cpu:
        per_tid[e.get("tid")].append((a, b, e["name"]))
    main = max(per_tid.values(), key=len, default=[])  # the thread that ran the frames
    mids = [0.5 * (end + start) for (_, end), (start, _) in zip(busy, busy[1:])]
    gaps = defaultdict(float)
    for ((_, end), (start, _)), ops in zip(zip(busy, busy[1:]), stacks(main, mids)):
        gaps[ops[-1] if ops else "python"] += (start - end) * 1e-6
    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "syncs": sum(1 for _, _, e in cpu if e["name"] == SYNC_OP),
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:top],
    }


def _frame(name: str):
    m = _FRAME.match(name)
    return (m.group(1), m.group(3)) if m else (name, "")


def place(stack) -> tuple:
    """(module, function, launched by the kernels' dispatch) of a launch
    whose Python stack is `stack` (outermost first): the deepest frame in
    ``libfluid_tpu_torch/sim/`` other than the dispatch module, or
    (None, None, ...)."""
    hand = any(path.endswith(DISPATCH) and fn == "launch" for path, fn in stack)
    for path, fn in reversed(stack):
        i = path.find(SIM)
        if i >= 0 and not path.endswith(DISPATCH):
            return path[i + len(SIM):], fn, hand
    return None, None, hand


def kernels(events) -> list:
    """Every device operation with its length in seconds and its place: a
    dict of ``name``, ``s``, ``module``, ``function``, ``hand`` (launched
    through the kernels' dispatch) and ``placed`` (its launch and stack were
    found)."""
    launch_of = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch_of[e["args"]["correlation"]] = e
    frames = defaultdict(list)
    for a, b, e in _spans(events, ("python_function",)):
        frames[e.get("tid")].append((a, b, _frame(e["name"])))
    launches = defaultdict(list)
    for corr, e in launch_of.items():
        launches[e.get("tid")].append((float(e["ts"]), corr))
    where = {}
    for tid, todo in launches.items():
        todo.sort()
        for (_, corr), stack in zip(todo, stacks(frames.get(tid, []), [t for t, _ in todo])):
            where[corr] = place(stack)
    out = []
    for a, b, e in _spans(events, DEVICE_CATS):
        corr = e.get("args", {}).get("correlation")
        module, function, hand = where.get(corr, (None, None, False))
        out.append({"name": e["name"], "s": (b - a) * 1e-6, "module": module, "function": function,
                    "hand": hand, "placed": corr in where})
    return out


def layer_ms(prof, modules, function=None):
    """Device ms per substep of the kernels placed in `modules` (file names
    under ``libfluid_tpu_torch/sim/``), those of functions whose name holds
    `function` where given; None where the traced replay placed no kernel
    (no stacks, or none resolved)."""
    if not prof or not any(k["module"] for k in prof.get("kernels", [])):
        return None
    substeps = sum(c.get("substeps", 0.0) for c in prof["counts"])
    s = sum(k["s"] for k in prof["kernels"]
            if k["module"] in modules and (function is None or function in k["function"]))
    return 1e3 * s / substeps if substeps else None


def idle_pct(prof):
    """The share of the traced replay's wall time in which no device
    operation ran; None where the trace holds none (no device)."""
    if not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
