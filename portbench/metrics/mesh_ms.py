"""``mesh_ms``: the mesher's span (``generate_mesh``, synchronized at both
ends), the mean over the window's frames (ms)."""


def read(run):
    s = run.spans.get("mesh") if run.spans else None
    return 1e3 * sum(s) / len(s) if s else None
