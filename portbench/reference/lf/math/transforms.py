"""Affine transforms (port of ``libfluid_tpu.math.transforms``).

Transforms are (3, 4) row-major matrices [R|t]; points and directions have
a trailing axis of 3. Euler rotation composes Z, then Y, then X. Inputs that
are not tensors become float32 tensors on the CPU, as JAX's default dtype
has them, so the canned scenes' transforms carry the same bits.
"""

from __future__ import annotations

import torch


def _f32(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=torch.float32)


def scale(s) -> torch.Tensor:
    """Diagonal scale as a (3, 4) transform."""
    s = _f32(s) * torch.ones(3)
    return torch.cat([torch.diag(s), torch.zeros((3, 1))], dim=-1)


def rotate_euler(angles) -> torch.Tensor:
    """(3, 3) rotation by Euler angles applied Z, then Y, then X."""
    a = _f32(angles)
    cx, sx = torch.cos(a[0]), torch.sin(a[0])
    cy, sy = torch.cos(a[1]), torch.sin(a[1])
    cz, sz = torch.cos(a[2]), torch.sin(a[2])
    one, zero = torch.ones((), dtype=a.dtype), torch.zeros((), dtype=a.dtype)
    rx = torch.stack([torch.stack([one, zero, zero]), torch.stack([zero, cx, -sx]),
                      torch.stack([zero, sx, cx])])
    ry = torch.stack([torch.stack([cy, zero, sy]), torch.stack([zero, one, zero]),
                      torch.stack([-sy, zero, cy])])
    rz = torch.stack([torch.stack([cz, -sz, zero]), torch.stack([sz, cz, zero]),
                      torch.stack([zero, zero, one])])
    return rx @ ry @ rz


def scale_rotate_translate(s, euler, t) -> torch.Tensor:
    """[R S | t] as a (3, 4) transform."""
    s = _f32(s) * torch.ones(3)
    r = rotate_euler(euler) * s[None, :]
    return torch.cat([r, _f32(t).reshape(3, 1).to(r.dtype)], dim=-1)


def apply_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply a (3, 4) transform to points with trailing axis 3."""
    return p @ m[:, :3].T + m[:, 3]


def apply_vector(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply the linear part of a (3, 4) transform to direction vectors."""
    return v @ m[:, :3].T


def inverse(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a (3, 4) affine transform as another (3, 4) transform."""
    rinv = torch.linalg.inv(m[:, :3])
    return torch.cat([rinv, (-rinv @ m[:, 3]).reshape(3, 1)], dim=-1)
