"""Profiling and timing utilities (port of ``libfluid_tpu.profiling``).

- :func:`sync` / :func:`timeit`: wall-clock timing that ends with a
  ``torch.cuda.synchronize`` of the tensors' device, so the device's queue
  has drained.
- :func:`trace`: a ``torch.profiler`` context writing a Chrome/Perfetto
  trace with the device's own kernel times into a directory.
- :class:`StageTimer`: named-stage accumulator for step loops, timed on
  the device's clock with CUDA events (on the host's clock for CPU work).
- :func:`span`, :func:`count`, :func:`read`, :func:`blocking`: the
  program's own record of where the host spends a frame (see below).

The record. The port opens a :func:`span` at each layer boundary (``step``,
``substep`` and its stages, ``mesh``, ``scene``, ``accel``, ``render``) and
counts at the sites where the work happens: every blocking read of a device
value (:func:`read`, :func:`blocking`: ``reads`` and ``read_wait_ns``, in
total and per site as ``reads.<site>`` and ``read_wait_ns.<site>``) and the
pressure solve's ``cg_iterations``. A span holds its name, parent, depth,
frame, host start and end (``time.perf_counter_ns``) and its counters; a
count goes to the innermost open span, and outside any span it is dropped.
A top-level ``step`` span starts a frame; any other top-level span joins
the last frame (so a rendered frame holds its ``step``, ``mesh``,
``scene``, ``accel`` and ``render``), or starts one if the record is empty.
A span opened directly inside one of the same name adds nothing to it
(``render.render`` calling ``trace_persistent``).

Recording is on only while a ``torch.profiler`` session records or inside
:func:`tracing`. Under a profiler each span is also a ``record_function``
range of its name, so the stages appear in the Chrome trace as
``user_annotation`` events on the kernels' clock. Off, :func:`span` returns
one shared no-op context after a flag test and :func:`count` returns at
once; on or off, the record adds no device work and no host read. Read it
with :func:`frames`; :func:`clear` empties it.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

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
        """Time the body as stage `name`, inside a :func:`span` of the same
        name."""
        with span(name):
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


# ---------------------------------------------------------------------------
# The record: spans and counters
# ---------------------------------------------------------------------------


class Span:
    """One recorded span: `start_ns` and `end_ns` on the host's
    ``time.perf_counter_ns`` clock (`end_ns` None while open), `parent` the
    span it opened in (None at the top), `frame` the id its frame's spans
    share, `counters` what was counted while it was the innermost open
    span."""

    __slots__ = ("name", "parent", "depth", "frame", "start_ns", "end_ns", "counters", "children_ns", "_range")

    def __init__(self, name: str, parent: Optional["Span"], frame: int):
        self.name, self.parent, self.frame = name, parent, frame
        self.depth = 0 if parent is None else parent.depth + 1
        self.start_ns = self.end_ns = None  # set as the span opens and closes
        self.counters: Dict[str, int] = {}
        self.children_ns = 0
        self._range = None

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def self_ns(self) -> int:
        """Its length less the parts its children cover."""
        return self.ns - self.children_ns


class Frame(NamedTuple):
    """The spans of one frame, in the order they opened."""

    id: int
    spans: List[Span]

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def below(self, name: str) -> List[Span]:
        """The spans named `name` and all their descendants."""
        inside = set()
        for s in self.spans:  # a parent opens before its children
            if s.name == name or id(s.parent) in inside:
                inside.add(id(s))
        return [s for s in self.spans if id(s) in inside]

    def total(self, key: str, under: Optional[str] = None) -> int:
        """Counter `key` summed over the frame's spans, or over the spans
        at or below those named `under`."""
        return sum(s.counters.get(key, 0) for s in (self.spans if under is None else self.below(under)))


_RECORD: List[Span] = []  # the spans in the order they opened
_OPEN: List[Span] = []  # the open spans, innermost last
_STATE = {"tracing": 0, "frame": -1}


class _Null:
    """The one context :func:`span` and :func:`blocking` return while
    recording is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Open:
    """The context of a recorded span."""

    __slots__ = ("name", "span")

    def __init__(self, name: str):
        self.name, self.span = name, None

    def __enter__(self):
        parent = _OPEN[-1] if _OPEN else None
        if parent is not None and parent.name == self.name:
            return None  # one span with the open span of its name
        if parent is not None:
            frame = parent.frame
        else:
            if self.name == "step" or not _RECORD:
                _STATE["frame"] += 1
            frame = _STATE["frame"]
        s = self.span = Span(self.name, parent, frame)
        if _autograd_profiler._is_profiler_enabled:
            s._range = _autograd_profiler.record_function(self.name)
            s._range.__enter__()
        _RECORD.append(s)
        _OPEN.append(s)
        s.start_ns = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        s = self.span
        if s is None:
            return False
        s.end_ns = time.perf_counter_ns()
        if s._range is not None:
            s._range.__exit__(None, None, None)
            s._range = None
        _OPEN.pop()
        if s.parent is not None:
            s.parent.children_ns += s.ns
        return False


def span(name: str):
    """A context that records its body as span `name` while recording is
    on, and is one shared no-op context while it is off."""
    if not (_STATE["tracing"] or _autograd_profiler._is_profiler_enabled):
        return _NULL
    return _Open(name)


def spanned(name: str):
    """Decorator: each call of the function is a :func:`span` `name`."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return run

    return wrap


def count(key: str, n: int = 1) -> None:
    """Add `n` to counter `key` of the innermost open span (nothing while
    recording is off or no span is open)."""
    if _OPEN:
        c = _OPEN[-1].counters
        c[key] = c.get(key, 0) + n


def _counted(site: str, wait_ns: int) -> None:
    c = _OPEN[-1].counters
    for key, n in (("reads", 1), ("read_wait_ns", wait_ns), ("reads." + site, 1),
                   ("read_wait_ns." + site, wait_ns)):
        c[key] = c.get(key, 0) + n


def read(t: torch.Tensor, site: str):
    """The Python value of the one-element tensor `t` (``t.item()``), a
    read that blocks the host until the device has computed `t`. While
    recording, it counts as one read under `site`, with the ns the host
    waited in it."""
    if not _OPEN:
        return t.item()
    t0 = time.perf_counter_ns()
    value = t.item()
    _counted(site, time.perf_counter_ns() - t0)
    return value


class _Blocking:
    __slots__ = ("site", "t0")

    def __init__(self, site: str):
        self.site = site

    def __enter__(self):
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        if _OPEN:
            _counted(self.site, time.perf_counter_ns() - self.t0)
        return False


def blocking(site: str):
    """A context around one library call that reads from the device inside
    it (``torch.nonzero``; ``torch.bincount``, which on the card reads its
    input's bounds back): one read under `site`, as :func:`read` counts,
    with the call's host time as its wait. The CPU counts the same sites,
    so a count does not depend on the device."""
    if not _OPEN:
        return _NULL
    return _Blocking(site)


@contextlib.contextmanager
def tracing():
    """Record while the block runs, with or without a profiler."""
    _STATE["tracing"] += 1
    try:
        yield
    finally:
        _STATE["tracing"] -= 1


def frames() -> List[Frame]:
    """The record grouped by frame, frames and spans in the order they
    opened (a span still open has ``end_ns`` None)."""
    by_frame: Dict[int, List[Span]] = {}
    for s in _RECORD:
        by_frame.setdefault(s.frame, []).append(s)
    return [Frame(fid, spans) for fid, spans in by_frame.items()]


def clear() -> None:
    """Empty the record. A span open now still closes, unrecorded."""
    _RECORD.clear()
