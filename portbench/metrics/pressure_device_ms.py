"""``pressure_device_ms``: device ms per substep of the kernels launched from
``sim/pressure.py`` and ``sim/multigrid.py`` (the MG-PCG solve: the fused
V-cycle, the operator, the vector and reduction operations), by the Python
stack of each launch."""

from portbench.trace import layer_ms


def read(run):
    return layer_ms(run.profile, ("pressure.py", "multigrid.py"))
