"""``setup_s``: from the process's start to the window's (s): imports, the
card's context, the kernel library loaded (built in a checkout's first
run), seeding, the settle frames, one warm-up frame and, with ``--trace
1``, the traced replays."""


def read(run):
    return run.setup_s
