"""The program's own record of spans and counters
(``libfluid_tpu_torch.profiling``), as a traced run leaves it: the frames of
the replay whose trace gives ``device_idle_pct``.

The profiler sessions of a traced run record, in order, one warm-up frame,
``profile.frames`` frames (that replay), and with ``profile.stack`` as many
again under Python stacks; the window runs with the profiler and so the
record off. A program without the record gives nothing, and neither does a
record whose frames do not hold one ``substep`` span for each substep the
replay's ``Diagnostics`` counted.
"""

from __future__ import annotations

import importlib


def replay_frames(run):
    """The record's frames of the traced replay, or None."""
    prof = run.profile
    if not prof:
        return None
    try:
        frames_of = getattr(importlib.import_module("libfluid_tpu_torch.profiling"), "frames", None)
    except ImportError:
        return None
    if frames_of is None:
        return None
    n = prof["frames"]
    frames = frames_of()
    end = len(frames) - (n if "kernels" in prof else 0)
    picked = frames[max(end - n, 0):end]
    counts = prof.get("counts", [])
    if len(picked) != n or len(counts) != n:
        return None
    for f, c in zip(picked, counts):
        if any(s.end_ns is None for s in f.spans) or len(f.named("substep")) != c.get("substeps"):
            return None
    return picked


def per_frame(run, key: str, under=None):
    """Counter `key` summed over each frame (or over the spans at or below
    those named `under`), the mean over the replay's frames."""
    frames = replay_frames(run)
    return sum(f.total(key, under) for f in frames) / len(frames) if frames else None


def ms_per_substep(run, name: str):
    """The host ms of the spans named `name`, summed and divided by the
    replay's substeps."""
    frames = replay_frames(run)
    if not frames:
        return None
    substeps = sum(len(f.named("substep")) for f in frames)
    ns = sum(s.ns for f in frames for s in f.named(name))
    return ns / 1e6 / substeps if substeps else None
