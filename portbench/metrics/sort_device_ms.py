"""``sort_device_ms``: device ms per substep of the kernels launched from
``sim/slotsort.py``, ``sim/slots.py`` and ``sim/binning.py`` (the sort and
the slot grid, kernel A), by the Python stack of each launch."""

from portbench.trace import layer_ms


def read(run):
    return layer_ms(run.profile, ("slotsort.py", "slots.py", "binning.py"))
