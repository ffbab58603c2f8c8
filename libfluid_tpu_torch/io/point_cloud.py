"""Whitespace "naive" point-cloud text format (reference
``point_cloud.h:15-37``): one xyz triple per line, interchangeable with the
reference's ``points.txt`` exports. A copy of
``libfluid_tpu.io.point_cloud``."""

from __future__ import annotations

import numpy as np


def save_points(path, positions, active=None):
    pos = np.asarray(positions)
    if active is not None:
        pos = pos[np.asarray(active)]
    with open(path, "w") as f:
        for p in pos:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")


def load_points(path):
    return np.loadtxt(path, ndmin=2)
