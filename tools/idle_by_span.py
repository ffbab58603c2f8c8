"""A benchmark cell's traced replay read against the port's own record of
spans and counters (``libfluid_tpu_torch/profiling.py``), on the card:

    python tools/idle_by_span.py dam128.frames [frames] [seed]

It builds the cell as ``portbench/harness.py`` does (settle frames, the
snapshot, one warm-up frame under the profiler), replays `frames` frames
(the cell's ``profile.frames`` by default) under ``torch.profiler``, writes
the Chrome trace to ``chiprun_out/trace_<cell>.json.gz`` and prints:

- the record per frame: each counter (reads and waits by site,
  ``cg_iterations``) and each span's host ms, total and self;
- every ``aten::_local_scalar_dense`` of the replay by the span it ran in
  and the CPU ops around it, as a device read where a device-to-host copy
  was issued inside it and as a host read of a CPU value where none was,
  and every device-to-host copy by span and op;
- for each frame, the device's idle gaps by the innermost span at each
  gap's middle, beside the same gaps named by the innermost CPU op (as the
  benchmark's ``breakdown`` names them), and where the op names "python"
  and ``_Solve`` fall among the spans;
- device ms per substep by the span that launched each device operation.

With ``ops`` in place of a cell it prints the reads and copies of the
library calls the read sites wrap (``torch.bincount``, ``torch.nonzero``),
of ``one_hot`` and of a masked fill with a scalar, on the card.
"""

import bisect
import collections
import gzip
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("LIBFLUID_CACHE_DIR", str(ROOT / "portbench" / ".cache"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from libfluid_tpu_torch import profiling  # noqa: E402
from portbench import harness, hostcopy, trace  # noqa: E402
from portbench.system import Program  # noqa: E402

OUT = ROOT / "chiprun_out"
ACTS = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def log(msg: str) -> None:
    print(msg, flush=True)


def ops_probe() -> None:
    x = torch.randint(0, 1000, (1 << 20,), device="cuda")
    calls = (("bincount", lambda: torch.bincount(x, minlength=1001)),
             ("one_hot", lambda: torch.nn.functional.one_hot(x % 3, 3)),
             ("nonzero", lambda: torch.nonzero(x > 500)),
             ("masked fill with a scalar", lambda: x.clone().__setitem__(x > 500, 7)))
    for what, fn in calls:
        fn()
        torch.cuda.synchronize()
        with profile(activities=ACTS) as prof:
            fn()
            torch.cuda.synchronize()
        events = trace.events_of(prof)
        lsd = sum(1 for e in events if e.get("name") == trace.SYNC_OP)
        d2h = sum(1 for e in events if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", ""))
        log(f"{what}: _local_scalar_dense {lsd}, device-to-host copies {d2h}")


def intervals(events, cats, tid=None):
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e) for e in events
            if e.get("cat") in cats and e.get("ph") == "X" and (tid is None or e.get("tid") == tid)]


def top(d: dict, n: int = 99) -> str:
    return ", ".join(f"{k} {v:.3f}" for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n])


def replay(cell_name: str, n, seed: int):
    """The record's frames and the profiler's events of `n` replayed
    frames of the cell (its ``profile.frames`` where `n` is None)."""
    bench = harness.Bench(ROOT)
    cell = bench.cell(cell_name)
    conf, mix = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    n = n or mix["profile"]["frames"]
    actions = [(a, bench.module("actions", a)) for a in mix["actions"]]
    settle = [(a, bench.module("actions", a)) for a in harness.SETTLE_ACTIONS]
    f = harness.Frame(Program(torch.device("cuda")), conf, seed)
    for _, a in dict.fromkeys(settle + actions):
        a.setup(f)
    settle[0][1].seed(f)
    for _ in range(mix["settle_frames"]):
        harness.run_frame(f, settle)
    snapshot = hostcopy.clone(f.state)
    harness.replay(f, snapshot, actions, 1)
    with profile(activities=ACTS):
        harness.replay(f, snapshot, actions, 1)
    profiling.clear()
    counts = []
    with profile(activities=ACTS) as prof:
        window = harness.replay(f, snapshot, actions, n, counts)
    log(f"== {cell_name}, seed {seed}: {n} frames in {window:.4f} s; per frame "
        f"{[{k: float(v) for k, v in c.items()} for c in counts]}")
    return profiling.frames(), trace.events_of(prof), n


def main(cell_name: str, n, seed: int) -> None:
    frames, events, n = replay(cell_name, n, seed)
    OUT.mkdir(exist_ok=True)
    path = OUT / f"trace_{cell_name}.json.gz"
    with gzip.open(path, "wt") as fh:
        json.dump({"traceEvents": events}, fh)
    log(f"Chrome trace: {path}")

    nsub = sum(len(fr.named("substep")) for fr in frames)
    counters, ms, self_ms = collections.Counter(), collections.Counter(), collections.Counter()
    for s in (s for fr in frames for s in fr.spans):
        counters.update(s.counters)
        ms[s.name] += s.ns / 1e6 / n
        self_ms[s.name] += s.self_ns / 1e6 / n
    log(f"record: {len(frames)} frames, substep spans {[len(fr.named('substep')) for fr in frames]}")
    log("counters per frame: " + ", ".join(f"{k} {v / n:.2f}" for k, v in sorted(counters.items())))
    log("host ms per frame by span (total / self): " + ", ".join(
        f"{k} {ms[k]:.3f} / {self_ms[k]:.3f}" for k in sorted(ms, key=lambda k: -ms[k])))

    cpu = collections.defaultdict(list)
    for a, b, e in intervals(events, ("cpu_op",)):
        cpu[e.get("tid")].append((a, b, e["name"]))
    main_tid = max(cpu, key=lambda t: len(cpu[t]))
    ops = cpu[main_tid]
    ann = [(a, b, e["name"]) for a, b, e in intervals(events, ("user_annotation",), main_tid)]
    launch_at = {e["args"]["correlation"]: a for a, _, e in intervals(events, trace.LAUNCH_CATS)
                 if "correlation" in e.get("args", {})}

    copies = sorted(launch_at[e["args"]["correlation"]] for _, _, e in intervals(events, ("gpu_memcpy",))
                    if "DtoH" in e["name"] and e.get("args", {}).get("correlation") in launch_at)
    lsd = [(a, b) for a, b, name in ops if name == trace.SYNC_OP]
    at = [a + 1e-3 for a, _ in lsd]
    kinds = collections.Counter()
    for (a, b), sp, op in zip(lsd, trace.stacks(ann, at), trace.stacks(ops, at)):
        i = bisect.bisect_left(copies, a)
        kind = "device" if i < len(copies) and copies[i] <= b else "host"
        kinds[(kind, "/".join(sp[-2:]) or "-", " > ".join(op[-4:-1]))] += 1
    log(f"_local_scalar_dense per frame {len(lsd) / n:.2f}; device-to-host copies per frame {len(copies) / n:.2f}")
    for (kind, sp, chain), c in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"  {kind} read {c / n:7.2f} a frame  span {sp:28s} ops {chain}")
    places = collections.Counter((("/".join(sp[-2:]) or "-"), " > ".join(op[-3:]))
                                 for sp, op in zip(trace.stacks(ann, copies), trace.stacks(ops, copies)))
    for (sp, op), c in sorted(places.items(), key=lambda kv: -kv[1]):
        log(f"  device-to-host copy {c / n:7.2f} a frame  span {sp:28s} ops {op}")

    busy = trace.merge([(a, b) for a, b, _ in intervals(events, trace.DEVICE_CATS)])
    starts = sorted(a for a, _, name in ann if name == "step") + [max(b for _, b, _ in ann)]
    for k in range(len(starts) - 1):
        lo, hi = starts[k], starts[k + 1]
        gaps = [(e, s) for (_, e), (s, _) in zip(busy, busy[1:]) if lo <= 0.5 * (e + s) < hi]
        mids = [0.5 * (e + s) for e, s in gaps]
        by_span, by_op, cross = collections.Counter(), collections.Counter(), collections.Counter()
        for (e, s), sp, op in zip(gaps, trace.stacks(ann, mids), trace.stacks(ops, mids)):
            span_name, op_name = (sp[-1] if sp else "(no span)"), (op[-1] if op else "python")
            by_span[span_name] += (s - e) / 1e3
            by_op[op_name] += (s - e) / 1e3
            cross[(op_name, span_name)] += (s - e) / 1e3
        dev_ms = sum(min(b, hi) - max(a, lo) for a, b in busy if b > lo and a < hi) / 1e3
        log(f"frame {k}: wall {(hi - lo) / 1e3:.1f} ms, device busy {dev_ms:.1f} ms, idle in gaps "
            f"{sum(by_span.values()):.1f} ms")
        log(f"  idle ms by span: {top(by_span)}")
        log(f"  idle ms by CPU op: {top(by_op, 10)}")
        for name in ("python", "_Solve"):
            log(f"  '{name}' by span: {top({sp: v for (o, sp), v in cross.items() if o == name})}")

    kern = sorted((launch_at[e["args"]["correlation"]], (b - a) / 1e3) for a, b, e in intervals(events, trace.DEVICE_CATS)
                  if e.get("args", {}).get("correlation") in launch_at)
    by_launch = collections.Counter()
    for (_, d), sp in zip(kern, trace.stacks(ann, [t for t, _ in kern])):
        by_launch[sp[-1] if sp else "(no span)"] += d / nsub
    log(f"device ms per substep by launching span: {top(by_launch)}")


if __name__ == "__main__":
    if sys.argv[1] == "ops":
        ops_probe()
    else:
        main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else None,
             int(sys.argv[3]) if len(sys.argv) > 3 else 2**31 + 101)
