"""``sort_host_ms``: host ms per substep of the ``sort`` spans of the traced
replay: the sort and slot grid (``slotsort.sort_and_build``, with the
sources' re-sort where there are sources), their enqueue and their reads."""

from portbench.spans import ms_per_substep


def read(run):
    return ms_per_substep(run, "sort")
