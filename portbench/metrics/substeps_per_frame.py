"""``substeps_per_frame``: CFL substeps a frame, the mean over the window's
frames (``Diagnostics.substeps``)."""


def read(run):
    vals = [r["substeps"] for r in run.frames if "substeps" in r]
    return sum(vals) / len(vals) if vals else None
