"""Profiling and timing utilities (port of ``libfluid_tpu.profiling``).

- :func:`sync` / :func:`timeit`: wall-clock timing that ends with a
  ``torch.cuda.synchronize`` of the tensors' device, so the device's queue
  has drained.
- :func:`trace`: a ``torch.profiler`` context writing a Chrome/Perfetto
  trace with the device's own kernel times into a directory.
- :class:`StageTimer`: named-stage accumulator for step loops, timed on
  the device's clock with CUDA events (on the host's clock for CPU work).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Tuple

import torch

from libfluid_tpu_torch.config import resolve_device


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


def sync(tree) -> None:
    """Wait for the device of every CUDA tensor in `tree` (any nesting of
    tuples, lists, dicts and NamedTuples) to drain its queue."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def timeit(f, *args, iters: int = 5, warmup: int = 2):
    """(seconds per call, last output) of f(*args), synchronized."""
    out = None
    for _ in range(max(warmup, 1)):
        out = f(*args)
    sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = f(*args)
    sync(out)
    return (time.perf_counter() - t0) / iters, out


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the CPU and, where there is one, the
    CUDA device, written to ``<log_dir>/trace.json`` (Chrome / Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Accumulates the time of named stages. On a CUDA device a stage is
    the time between two CUDA events recorded on the current stream around
    it (the device's clock: the stage's kernels and any host gap that keeps
    the device waiting); elsewhere the host's clock. Events are read, with
    one synchronize, when :attr:`totals` or :meth:`report` is asked. The
    device is where the timed work runs (None: the CUDA card; ``"cpu"`` on
    request)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._host: Dict[str, float] = {}
        self._events: Dict[str, List[Tuple[torch.cuda.Event, torch.cuda.Event]]] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time the body as stage `name`."""
        if self.device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._events.setdefault(name, []).append((start, end))
        else:
            t0 = time.perf_counter()
            yield
            self._host[name] = self._host.get(name, 0.0) + time.perf_counter() - t0
        self.counts[name] = self.counts.get(name, 0) + 1

    @property
    def totals(self) -> Dict[str, float]:
        """Seconds per stage, summed over its calls."""
        out = dict(self._host)
        if self._events:
            torch.cuda.synchronize(self.device)
        for name, pairs in self._events.items():
            out[name] = out.get(name, 0.0) + sum(a.elapsed_time(b) for a, b in pairs) / 1e3
        return out

    def report(self) -> str:
        lines = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {tot * 1e3:9.1f} ms total  {tot / n * 1e3:8.1f} ms/call x{n}")
        return "\n".join(lines)
