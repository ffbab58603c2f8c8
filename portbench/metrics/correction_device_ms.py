"""``correction_device_ms``: device ms per substep of the kernels launched
from ``sim/correction.py`` and ``sim/jitterhash.py`` (kernel E, the
overflow springs, the gathers), by the Python stack of each launch."""

from portbench.trace import layer_ms


def read(run):
    return layer_ms(run.profile, ("correction.py", "jitterhash.py"))
