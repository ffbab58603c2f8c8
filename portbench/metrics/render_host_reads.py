"""``render_host_reads``: the renderer's reads of its loops' exit flags
(``renderer.loops.HOST_READS``) in the window, per frame."""


def read(run):
    return run.host_reads / len(run.frames)
