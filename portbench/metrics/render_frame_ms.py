"""``render_frame_ms``: the window's wall time over its rendered frames (ms):
step, mesh, scene and accelerator, render."""


def read(run):
    return 1e3 * run.window_s / len(run.frames)
