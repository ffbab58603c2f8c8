"""``p2g_device_ms``: device ms per substep of the kernels launched from the
P2G functions of ``sim/transfers.py`` (kernel B through ``sim/kernels.py``,
the overflow scatter, the normalisation), by the Python stack of each
launch."""

from portbench.trace import layer_ms


def read(run):
    return layer_ms(run.profile, ("transfers.py",), "p2g")
