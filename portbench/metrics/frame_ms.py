"""``frame_ms``: the window's wall time over the frames it completed (ms)."""


def read(run):
    return 1e3 * run.window_s / len(run.frames)
