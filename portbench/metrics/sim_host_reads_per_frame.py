"""``sim_host_reads_per_frame``: the program's counted reads of device
values (``reads`` of ``libfluid_tpu_torch.profiling``) at or below the
``step`` span, per frame of the traced replay."""

from portbench.spans import per_frame


def read(run):
    return per_frame(run, "reads", under="step")
