"""``render_ms``: the spans of the scene (``inject_mesh`` and
``accel.build``) and of the render (``trace_persistent``) together, the
mean over the window's frames (ms)."""


def read(run):
    if not run.spans or not run.spans.get("render"):
        return None
    return 1e3 * (sum(run.spans.get("scene", [])) + sum(run.spans["render"])) / len(run.spans["render"])
