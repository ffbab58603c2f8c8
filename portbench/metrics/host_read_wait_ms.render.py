"""``host_read_wait_ms.render``: the host's ms blocked in the program's
counted reads (``read_wait_ns``), per rendered frame of the traced replay
(step, mesh, scene, accelerator and render)."""

from portbench.spans import per_frame


def read(run):
    ns = per_frame(run, "read_wait_ns")
    return ns / 1e6 if ns is not None else None
