"""Geometric intersection tests, batched (port of
``libfluid_tpu.math.intersection``). Every test returns an explicit hit
mask beside t; inputs broadcast, trailing axis 3."""

from __future__ import annotations

import torch

_BIG = 3.0e38  # "infinite" t, finite in float32


def ray_triangle(origin, direction, p0, e1, e2, eps=1e-9):
    """Moller-Trumbore ray/triangle test, both orientations. Triangle as a
    vertex `p0` and edges `e1 = p1 - p0`, `e2 = p2 - p0`. Returns
    (hit, t, u, v), t = _BIG where there is no hit."""
    pvec = torch.linalg.cross(*torch.broadcast_tensors(direction, e2))
    det = torch.sum(e1 * pvec, dim=-1)
    valid = torch.abs(det) > eps
    inv_det = 1.0 / torch.where(valid, det, torch.ones_like(det))
    tvec = origin - p0
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = torch.linalg.cross(*torch.broadcast_tensors(tvec, e1))
    v = torch.sum(direction * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det
    hit = valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return hit, torch.where(hit, t, torch.full_like(t, _BIG)), u, v


def ray_aabb(origin, inv_direction, box_min, box_max, t_max=_BIG):
    """Slab test with 1/direction: (hit, t_near), hit where the segment
    (0, t_max) overlaps the box."""
    t0 = (box_min - origin) * inv_direction
    t1 = (box_max - origin) * inv_direction
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (tmax >= torch.clamp(tmin, min=0.0)) & (tmin < t_max)
    return hit, torch.clamp(tmin, min=0.0)


def ray_unit_sphere(origin, direction):
    """Ray against the unit sphere at the origin: (hit, t) of the nearest
    positive root."""
    a = torch.sum(direction * direction, dim=-1)
    b = 2.0 * torch.sum(origin * direction, dim=-1)
    c = torch.sum(origin * origin, dim=-1) - 1.0
    disc = b * b - 4.0 * a * c
    has_root = disc >= 0.0
    sq = torch.where(has_root, torch.sqrt(torch.where(has_root, disc, torch.ones_like(disc))),
                     torch.zeros_like(disc))
    t_near = (-b - sq) / (2.0 * a)
    t_far = (-b + sq) / (2.0 * a)
    t = torch.where(t_near > 0.0, t_near, t_far)
    hit = has_root & (t > 0.0)
    return hit, torch.where(hit, t, torch.full_like(t, _BIG))


def aabb_triangle(box_center, box_half, p0, p1, p2):
    """Separating-axis overlap of an axis-aligned box and a triangle
    (Akenine-Moller): a boolean mask, inputs broadcast."""
    v0 = p0 - box_center
    v1 = p1 - box_center
    v2 = p2 - box_center
    e0 = v1 - v0
    e1 = v2 - v1
    e2 = v0 - v2

    tri_min = torch.minimum(torch.minimum(v0, v1), v2)
    tri_max = torch.maximum(torch.maximum(v0, v1), v2)
    sep_box = torch.any((tri_min > box_half) | (tri_max < -box_half), dim=-1)

    n = torch.linalg.cross(e0, e1)
    d = -torch.sum(n * v0, dim=-1)
    r = torch.sum(box_half * torch.abs(n), dim=-1)
    sep_plane = (d > r) | (d < -r)

    def axis_test(axis):
        q0 = torch.sum(axis * v0, dim=-1)
        q1 = torch.sum(axis * v1, dim=-1)
        q2 = torch.sum(axis * v2, dim=-1)
        lo = torch.minimum(torch.minimum(q0, q1), q2)
        hi = torch.maximum(torch.maximum(q0, q1), q2)
        rad = torch.sum(box_half * torch.abs(axis), dim=-1)
        return (lo > rad) | (hi < -rad)

    units = torch.eye(3, dtype=e0.dtype, device=e0.device)
    sep_cross = torch.zeros(sep_box.shape, dtype=torch.bool, device=sep_box.device)
    for edge in (e0, e1, e2):
        for j in range(3):
            axis = torch.linalg.cross(torch.broadcast_to(units[j], edge.shape), edge)
            sep_cross = sep_cross | axis_test(axis)

    return ~(sep_box | sep_plane | sep_cross)
