"""``cg_iters_per_substep``: CG iterations of the pressure solve, the mean
over the window's frames of each frame's last substep
(``Diagnostics.pressure_iterations``)."""


def read(run):
    vals = [r["cg_iterations"] for r in run.frames if "cg_iterations" in r]
    return sum(vals) / len(vals) if vals else None
