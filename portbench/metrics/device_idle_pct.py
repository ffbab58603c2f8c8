"""``device_idle_pct``: the share of the traced replay's wall time in which
no kernel, copy or fill ran on the device (the union of their intervals)."""

from portbench.trace import idle_pct


def read(run):
    return idle_pct(run.profile)
