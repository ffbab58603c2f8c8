"""``p2g_host_ms``: host ms per substep of the ``p2g`` spans of the traced
replay: P2G (``transfers.p2g_slots``), ``mark_cells`` and the boundary
faces, their enqueue and their reads."""

from portbench.spans import ms_per_substep


def read(run):
    return ms_per_substep(run, "p2g")
