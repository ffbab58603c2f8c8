"""``kernel_roofline_pct``: the summed bound of the hand kernels' launches
over their summed device time in the traced replay (%). A launch's bound is
the roofline table's (``roofline/<kernel>.py``) from its own arguments; a
hand kernel that the table does not know counts with its time and a bound
of 0."""

from portbench.harness import roofline


def read(run):
    prof = run.profile
    if not prof or "kernels" not in prof:
        return None
    recs = roofline(prof, run.table).values()
    device = sum(r["s"] for r in recs)
    return 100.0 * sum(r["bound_s"] for r in recs) / device if device > 0 else None
