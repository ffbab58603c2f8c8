"""Linear interpolation helpers (port of ``libfluid_tpu.math.interp``)."""

from __future__ import annotations

import torch


def lerp(a, b, t):
    """a + (b - a) * t, elementwise."""
    return a + (b - a) * t


def bilerp(v00, v01, v10, v11, tx, ty):
    """Bilinear interpolation; ``v{y}{x}`` convention, tx varies fastest."""
    return lerp(lerp(v00, v01, tx), lerp(v10, v11, tx), ty)


def trilerp(v000, v001, v010, v011, v100, v101, v110, v111, tx, ty, tz):
    """Trilinear interpolation; ``v{z}{y}{x}`` convention."""
    return lerp(
        bilerp(v000, v001, v010, v011, tx, ty),
        bilerp(v100, v101, v110, v111, tx, ty),
        tz,
    )


def hat(x: torch.Tensor) -> torch.Tensor:
    """The trilinear hat max(0, 1-|x|) per component, multiplied over the
    trailing axis of 3 (x in cell units)."""
    return torch.prod(torch.clamp(1.0 - torch.abs(x), min=0.0), dim=-1)


def grad_hat(x: torch.Tensor, cell_size: float) -> torch.Tensor:
    """Gradient of :func:`hat` with respect to world-space position: sign(x)
    is -1 for x > 0 else +1, divided by the cell size."""
    neg_sign = torch.where(x > 0.0, -1.0, 1.0).to(x.dtype)
    n = 1.0 - torch.abs(x)
    gx = neg_sign[..., 0] * n[..., 1] * n[..., 2]
    gy = n[..., 0] * neg_sign[..., 1] * n[..., 2]
    gz = n[..., 0] * n[..., 1] * neg_sign[..., 2]
    return torch.stack([gx, gy, gz], dim=-1) / cell_size
