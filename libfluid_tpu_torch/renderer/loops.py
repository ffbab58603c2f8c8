"""The host side of the renderer's device loops.

The JAX package's ``lax.while_loop`` tests its exit condition on the
device; here a loop is a Python loop, and its exit test reads a flag back
from the device. :func:`flag` is that read, and counts it: the read waits
for every launch before it, so the count is how often a loop drains the
device's queue. ``HOST_READS`` counts always; the read is also a read site
of :mod:`libfluid_tpu_torch.profiling`, counted there while it records.
"""

from __future__ import annotations

import torch

from libfluid_tpu_torch import profiling

HOST_READS = {"count": 0}

# Iterations between two reads of a loop's exit flag. An iteration after the
# last live lane changes nothing, so a loop's result is that of testing every
# iteration. A traversal step costs less than a path tracer's iteration, so
# the traversal reads half as often.
TRACE_CHECK_EVERY = 4
TRAVERSE_CHECK_EVERY = 8


def reset_host_reads() -> None:
    HOST_READS["count"] = 0


def flag(t: torch.Tensor, site: str = "loops.flag") -> bool:
    """The bool of a one-element tensor, read back to the host (counted;
    `site` names the loop for the profiling record)."""
    HOST_READS["count"] += 1
    return bool(profiling.read(t, site))
