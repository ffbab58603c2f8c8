"""``frame_p95_ms``: the 95th percentile of the wall time of every frame of
the window, each ending in a synchronize (ms; linear interpolation)."""

import numpy as np


def read(run):
    return float(np.percentile([r["ms"] for r in run.frames], 95))
