"""``collide_host_ms``: host ms per substep of the ``collide`` spans of the
traced replay: the two collision passes (``collisions.resolve_collisions``),
their enqueue and their reads."""

from portbench.spans import ms_per_substep


def read(run):
    return ms_per_substep(run, "collide")
