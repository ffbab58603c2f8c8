"""The harness: one cell of ``BENCHMARK.json``, from the seed to the result.

A run builds the cell's configuration, seeds the state from ``--seed`` and
advances it by the traffic mix's ``settle_frames`` frames of the "step"
action alone, then takes a snapshot (the tensors and the CPU generator's state)
and warms every frame action up once from it. The window then replays
episodes of ``episode_frames`` frames from the snapshot, a frame being the
mix's ``actions`` in order, and ends with the first episode that ends after
``--seconds``. So every run does whole episodes of the same sequence of
work, and the seed varies the particles' jitter and the substeps' draws.

A frame is the testbed's, ``FRAME_DT`` seconds of simulated time. Each
ends in a synchronize and one copy of its failure flags and counts to the
host. ``CHECK_FRAMES`` frames of the first episode, drawn from the seed,
keep host copies of their inputs and answers; once the window has closed
and the program's state is freed, the reference (``reference/compare.py``)
runs them again and the gaps are held to the cell's limits
(``limits/<cell>.json``). The reference's seconds and device memory peak
are logged, and the keys of the configuration's "sim" group that it leaves
to the program (``reference/state_io.py``).

With ``--trace 1`` the set-up also replays ``profile.frames`` frames from
the snapshot under ``torch.profiler`` (device busy and idle, host reads,
the breakdown), again with Python stacks (where in the program each kernel
was launched) and again with the kernels' launch arguments recorded (the
roofline table's counts); the window then runs with a synchronized span
around every action. The metrics are read by ``metrics/<metric>.py``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import random
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from portbench import hostcopy, peaks, trace
from portbench.reference import state_io
from portbench.reference.compare import Reference

FRAME_DT = 1.0 / 60.0  # the testbed's frame
SETTLE_ACTIONS = ("step",)  # settle frames only simulate
CHECK_FRAMES = 2  # frames of the first episode held to the reference


class Bench:
    """``BENCHMARK.json`` and the files under ``portbench/`` that it names,
    from the root of a checkout."""

    def __init__(self, root):
        self.root = Path(root)
        self.dir = self.root / "portbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self._modules = {}

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.spec["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.dir / "limits" / f"{cell}.json").read_text())

    def module(self, kind: str, name: str):
        """``portbench/<kind>/<name>.py``, loaded once."""
        key = (kind, name)
        if key not in self._modules:
            path = self.dir / kind / f"{name}.py"
            spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def roofline(self) -> dict:
        """The roofline table: kernel name -> its counts' module."""
        return {p.stem: self.module("roofline", p.stem)
                for p in sorted((self.dir / "roofline").glob("*.py")) if not p.stem.startswith("_")}

    def metrics(self, cell: str, traced: bool) -> list:
        """The cell's end-to-end metrics, or with `traced` its per-layer
        metrics: those that list the cell, or list no cells and move an
        end-to-end metric that the cell reports."""
        def applies(m):
            return cell in m["workloads"] if "workloads" in m else True

        e2e = [m for m in self.spec["end_to_end"] if applies(m)]
        if not traced:
            return e2e
        reported = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Frame:
    """What the frame actions share: the system, the configuration, the
    seed, the frame's simulated seconds, and the objects the actions
    make."""

    def __init__(self, system, conf: dict, seed: int):
        self.system, self.conf, self.seed = system, conf, seed
        self.dt = FRAME_DT
        self.k = 0  # the frame's place in its episode


def run_frame(f: Frame, actions, spans=None) -> None:
    """The frame's (name, action) pairs in order; with `spans`, each
    between two synchronizes, its seconds appended under its name."""
    dev = f.system.device
    for name, a in actions:
        if spans is None:
            a.run(f)
            continue
        sync(dev)
        t0 = time.perf_counter()
        a.run(f)
        sync(dev)
        spans[name].append(time.perf_counter() - t0)


def read_frame(f: Frame, actions) -> dict:
    """The frame's failure flags and counts, in one copy to the host."""
    named = {}
    for _, a in actions:
        named.update({("flag", k): v for k, v in a.flags(f).items()})
        named.update({("value", k): v for k, v in a.values(f).items()})
    keys = list(named)
    vals = torch.stack([torch.as_tensor(named[k]).to(torch.float64).reshape(()) for k in keys]).cpu().tolist()
    out = {"failures": [k[1] for k, v in zip(keys, vals) if k[0] == "flag" and v]}
    out.update({k[1]: v for k, v in zip(keys, vals) if k[0] == "value"})
    return out


def replay(f: Frame, snapshot, actions, frames: int, counts=None) -> float:
    """`frames` frames of an episode from the snapshot; their wall seconds.
    Each frame's counts (``values`` of its actions, device tensors) are
    appended to `counts` where given."""
    dev = f.system.device
    f.state = hostcopy.clone(snapshot)
    sync(dev)
    t0 = time.perf_counter()
    for k in range(frames):
        f.k = k
        run_frame(f, actions)
        if counts is not None:
            counts.append({n: v for _, a in actions for n, v in a.values(f).items()})
    sync(dev)
    return time.perf_counter() - t0


def profiles(f: Frame, snapshot, actions, mix: dict, table: dict, log) -> dict:
    """The traced run's three replays of ``profile.frames`` frames (see the
    module's docstring); what the per-layer metrics read."""
    from torch.profiler import ProfilerActivity, profile

    spec = mix["profile"]
    n = spec["frames"]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if f.system.device.type == "cuda" else [])
    out = {"frames": n}

    with profile(activities=acts):  # the profiler's own first use
        replay(f, snapshot, actions, 1)
    counts = []
    with profile(activities=acts) as prof:
        out["window_s"] = replay(f, snapshot, actions, n, counts)
    out["counts"] = [{k: float(v) for k, v in c.items()} for c in counts]
    out.update(trace.summary(trace.events_of(prof)))

    if spec.get("stack"):
        before = f.system.launches()
        with profile(activities=acts, with_stack=True) as prof:
            replay(f, snapshot, actions, n)
        launched = {k: v - before.get(k, 0) for k, v in f.system.launches().items() if v - before.get(k, 0)}
        events = trace.events_of(prof)
        cats = {}
        for e in events:
            cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
        log(f"traced replay with Python stacks: events by category {cats}")
        out["kernels"] = trace.kernels(events)
        placed = sum(k["s"] for k in out["kernels"] if k["module"] is not None)
        total = sum(k["s"] for k in out["kernels"])
        log(f"kernels placed in a module of libfluid_tpu_torch/sim: {placed:.6f} of {total:.6f} device "
            f"s; unattributed {total - placed:.6f} s")
        seen = {}
        for k in out["kernels"]:
            name = _table_name(k["name"], table)
            if k["hand"] or name:
                seen[name or k["name"]] = seen.get(name or k["name"], 0) + 1
        missed = {name: (count, seen.get(name, 0)) for name, count in launched.items()
                  if seen.get(name, 0) != count}
        log(f"kernel launches the profiler saw against kernels.LAUNCHES: {seen} against {launched}; "
            f"differing (launched, seen): {missed or 'none'}")

    if spec.get("roofline"):
        costs = {}

        def hook(name, args):
            if name in table:
                costs.setdefault(name, []).append(peaks.bound_s(*table[name].cost(table[name].measure(args))))

        with f.system.launch_hook(hook):
            replay(f, snapshot, actions, n)
        out["bounds"] = costs
    return out


def _table_name(kernel: str, table: dict):
    """The roofline table's name of a device kernel, by its symbol and
    whether it computes in bfloat16; None if the table has none."""
    bf16 = "bfloat16" in kernel
    for name, mod in table.items():
        if mod.SYMBOL in kernel and mod.BF16 == bf16:
            return name
    return None


def roofline(prof: dict, table: dict) -> dict:
    """Per kernel of the table that ran: its device seconds, launches seen,
    and the summed bound of its launches (those the roofline replay counted,
    scaled to the launches seen); the hand kernels the table does not know,
    with their device seconds and a bound of 0."""
    seen = {}
    for k in prof["kernels"]:
        name = _table_name(k["name"], table)
        if name is None and not k["hand"]:
            continue
        rec = seen.setdefault(name or f"unknown: {k['name'][:80]}", {"s": 0.0, "n": 0, "bound_s": 0.0})
        rec["s"] += k["s"]
        rec["n"] += 1
    for name, rec in seen.items():
        bounds = prof.get("bounds", {}).get(name, [])
        if bounds:
            rec["bound_s"] = sum(bounds) * rec["n"] / len(bounds)
    return seen


def run_cell(bench: Bench, workload: str, seed: int, seconds: float, traced: bool, device="cuda",
             t_start=None, system=None, control=None, log=None):
    """Run one cell; returns (the result's JSON object, the numbers compared
    with their limits, every number the comparison gave). `system` is the
    program (by default ``portbench.system.Program``). With `control` (the
    reference's lower-precision control, ``reference/control.py``), each
    compared frame is the control's, run from the program's state before
    it, in the program's place."""
    t_start = time.time() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    dev = torch.device(device)
    cell = bench.cell(workload)
    conf, mix, limits = bench.config(cell["config"]), bench.traffic(cell["traffic"]), bench.limits(workload)
    if system is None:
        from portbench.system import Program

        system = Program(dev)
    actions = [(a, bench.module("actions", a)) for a in mix["actions"]]
    settle = [(a, bench.module("actions", a)) for a in SETTLE_ACTIONS]
    f = Frame(system, conf, seed)
    for _, a in dict.fromkeys(settle + actions):
        a.setup(f)
    settle[0][1].seed(f)
    for _ in range(mix["settle_frames"]):
        run_frame(f, settle)
    snapshot = hostcopy.clone(f.state)
    replay(f, snapshot, actions, 1)  # every action's shapes, once
    if control is not None:
        g = Frame(control, conf, seed)
        for _, a in actions:
            a.setup(g)

    table = bench.roofline()
    prof = profiles(f, snapshot, actions, mix, table, log) if traced else None

    episode = mix["episode_frames"]
    picks = sorted(random.Random(seed).sample(range(episode), min(CHECK_FRAMES, episode)))
    spans = {name: [] for name, _ in actions} if traced else None
    records, cases = [], []
    reads0 = f.system.host_reads()
    sync(dev)
    if dev.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    t_last, n_episode = t0, 0
    while True:
        f.state = hostcopy.clone(snapshot)
        for k in range(episode):
            f.k = k
            case = {"frame": k} if n_episode == 0 and k in picks else None
            if case is not None:
                for _, a in actions:
                    getattr(a, "capture_before", lambda *_: None)(f, case)
                if control is not None:
                    g.state, g.k = control.from_program(case["pre"]), k
                    run_frame(g, actions)
            t1 = time.perf_counter()
            run_frame(f, actions, spans)
            sync(dev)
            t_last = time.perf_counter()
            records.append({"ms": (t_last - t1) * 1e3, **read_frame(f, actions)})
            if case is not None:
                for _, a in actions:
                    a.capture(f if control is None else g, case)
                cases.append(case)
        n_episode += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = t_last - t0
    host_reads = f.system.host_reads() - reads0
    window_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    memory_peak = max(setup_peak, window_peak) if dev.type == "cuda" else 0

    del f, snapshot
    if control is not None:
        del g
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    most = {k: max(r[k] for r in records) for k in records[0] if k not in ("ms", "failures")}
    ms = sorted(r["ms"] for r in records)
    log(f"window: {len(records)} frames in {window_s:.3f} s, {n_episode} episodes, the most in a frame "
        f"{most}; frame ms min {ms[0]:.1f} median {ms[len(ms) // 2]:.1f} max {ms[-1]:.1f}; comparing "
        f"frames {picks}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_ref = time.perf_counter()
    numbers = {}
    ref = Reference(conf, dev)
    left = state_io.program_keys(conf)
    if left:
        log(f"reference: the \"sim\" keys {left} are left to the program")
    for case in cases:
        for _, a in actions:
            for name, value in a.compare(case, ref).items():
                numbers[name] = max(numbers.get(name, 0.0), float(value))
    ref_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"reference: {time.perf_counter() - t_ref:.3f} s for {len(cases)} frames, device memory peak "
        f"{ref_peak} bytes")
    checks = {name: {"value": numbers.get(name), "limit": limit} for name, limit in limits.items()}
    correct = bool(cases) and bool(checks) and all(c["value"] is not None and c["value"] <= c["limit"]
                                                   for c in checks.values())

    run = SimpleNamespace(frames=records, window_s=window_s, setup_s=setup_s, peak_bytes=window_peak,
                          spans=spans, host_reads=host_reads, profile=prof, table=table)
    metrics = {}
    for m in bench.metrics(workload, traced):
        value = bench.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": len(records),
        "failed": sum(1 for r in records if r["failures"]),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": cell["chips"],
            "memory_peak_bytes": memory_peak,
        },
    }
    failures = sorted({x for r in records for x in r["failures"]})
    if failures:
        log(f"failed frames: {result['failed']} of {len(records)}: {failures}")
    if traced:
        result["device"]["busy_s"] = prof["busy_s"]
        result["device"]["window_s"] = prof["window_s"]
        result["breakdown"] = breakdown(prof, table)
    result["checks"] = {name: [c["value"], c["limit"]] for name, c in checks.items()}
    return result, checks, numbers


def breakdown(prof: dict, table: dict) -> dict:
    """The traced replay's device operations with the most time (a kernel
    of the roofline table with its share of its bound in the name) and its
    idle gaps by what the host was doing."""
    shares = {}
    if "kernels" in prof:
        for name, rec in roofline(prof, table).items():
            if rec["s"] > 0:
                shares[name] = 100.0 * rec["bound_s"] / rec["s"]
    ops = []
    for name, s in prof["device_ops"]:
        short = name[:100]
        tname = _table_name(name, table)
        if tname in shares:
            short = f"{short} [{tname}: {shares[tname]:.1f} % of its roofline]"
        ops.append([short, s])
    return {"device_ops": ops, "idle_gaps": [[name[:100], s] for name, s in prof["idle_gaps"]]}
