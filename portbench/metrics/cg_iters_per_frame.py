"""``cg_iters_per_frame``: CG iterations of every substep's pressure solve
(``cg_iterations``), per frame of the traced replay."""

from portbench.spans import per_frame


def read(run):
    return per_frame(run, "cg_iterations")
