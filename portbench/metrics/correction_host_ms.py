"""``correction_host_ms``: host ms per substep of the ``correction`` spans of
the traced replay: the position correction (``correction.correct_positions``
with its seed and bounds), their enqueue and their reads."""

from portbench.spans import ms_per_substep


def read(run):
    return ms_per_substep(run, "correction")
