"""``pressure_host_ms``: host ms per substep of the ``pressure`` spans of the
traced replay: the pressure solve (``pressure.solve``) and
``apply_pressure``, their enqueue and their reads."""

from portbench.spans import ms_per_substep


def read(run):
    return ms_per_substep(run, "pressure")
