"""Batched ray/scene intersection (port of ``libfluid_tpu.renderer.intersect``).

Every ray tests the triangles in chunks (bounded memory; Moller-Trumbore
over the ray x chunk block) and all spheres, keeping the nearest hit. A
scene with an accelerator (:mod:`portbench.reference.lf.renderer.accel`) walks
its uniform grid instead of the chunks.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from portbench.reference.lf.math import intersection as isect
from portbench.reference.lf.renderer.scene import Scene

_BIG = 3.0e38
TRI_CHUNK = 512
_VIS_TRI_CHUNK = 64  # triangles a step of the any-hit scan (a boolean: any chunking gives the same)


class HitRecord(NamedTuple):
    hit: torch.Tensor  # (R,) bool
    t: torch.Tensor  # (R,)
    position: torch.Tensor  # (R, 3)
    normal: torch.Tensor  # (R, 3) unit geometric normal
    mat_id: torch.Tensor  # (R,) int64
    prim_kind: torch.Tensor  # (R,) 0 = triangle, 1 = sphere
    prim_id: torch.Tensor  # (R,) int64
    uv: torch.Tensor  # (R, 2) barycentric (triangle) / spherical (sphere)


def _brute_force_tris(scene: Scene, origin, direction, t_max):
    """Nearest triangle per ray over chunks of at most ``TRI_CHUNK``
    triangles: (t, id, u, v), t == t_max and id == -1 for misses. The JAX
    package pads a chunk to a multiple of 128 (a TPU lane tile); here a
    scene of fewer triangles is one chunk of its own size. Pad rows never
    hit and the first of equal hits wins, so the result is the same.

    Under autograd (a geometry or ray tensor that requires grad) the search
    runs without grad, and t, u, v are recomputed with grad on each ray's
    chosen triangle by the same elementwise ``ray_triangle``: the same bits
    forward, the gradient the JAX package's ``take_along_axis`` passes, and
    no (rays, chunk) block kept for the backward."""
    tensors = (origin, direction, scene.tri_p0, scene.tri_e1, scene.tri_e2)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)):
        return _search_tris(scene, origin, direction, t_max)
    with torch.no_grad():
        _, best_id, _, _ = _search_tris(scene, origin, direction, t_max)
    hit_any = best_id >= 0
    tid = torch.clamp(best_id, min=0)
    _, t, u, v = isect.ray_triangle(origin, direction, scene.tri_p0[tid], scene.tri_e1[tid], scene.tri_e2[tid])
    zero = torch.zeros_like(u)
    return (torch.where(hit_any, t, torch.full_like(t, float(t_max))), best_id,
            torch.where(hit_any, u, zero), torch.where(hit_any, v, zero))


def _search_tris(scene: Scene, origin, direction, t_max):
    """The chunked nearest-hit search of :func:`_brute_force_tris`."""
    r = origin.shape[0]
    n_tri = scene.tri_p0.shape[0]
    best_t = torch.full((r,), float(t_max), dtype=origin.dtype, device=origin.device)
    best_id = torch.full((r,), -1, dtype=torch.int64, device=origin.device)
    best_u = torch.zeros((r,), dtype=origin.dtype, device=origin.device)
    best_v = torch.zeros((r,), dtype=origin.dtype, device=origin.device)
    o, d = origin[:, None, :], direction[:, None, :]
    for base in range(0, n_tri, TRI_CHUNK):
        sl = slice(base, base + TRI_CHUNK)
        hit, t, u, v = isect.ray_triangle(o, d, scene.tri_p0[None, sl], scene.tri_e1[None, sl],
                                          scene.tri_e2[None, sl])
        t = torch.where(hit, t, torch.full_like(t, _BIG))
        tj, j = torch.min(t, dim=1)
        closer = tj < best_t
        best_id = torch.where(closer, base + j, best_id)
        best_u = torch.where(closer, torch.gather(u, 1, j[:, None])[:, 0], best_u)
        best_v = torch.where(closer, torch.gather(v, 1, j[:, None])[:, 0], best_v)
        best_t = torch.minimum(best_t, tj)
    return best_t, best_id, best_u, best_v


def ray_cast(scene: Scene, origin: torch.Tensor, direction: torch.Tensor, t_max=_BIG) -> HitRecord:
    """Nearest hit for a batch of rays; directions need not be normalized
    (t is in units of |direction|). With ``scene.accel`` set the triangle
    search walks the uniform grid, else the chunked scan."""
    if scene.accel is not None:
        from portbench.reference.lf.renderer import accel as accel_mod

        tri_t, tri_id, tri_u, tri_v = accel_mod.traverse(
            scene.accel, accel_mod.pack_tris(scene), origin, direction, float(t_max))
    else:
        tri_t, tri_id, tri_u, tri_v = _brute_force_tris(scene, origin, direction, t_max)
    return finalize_hit(scene, origin, direction, tri_t, tri_id, tri_u, tri_v, t_max)


def _sphere_local(scene: Scene, origin, direction):
    """Rays in every sphere's local frame: (R, S, 3) origins (clipped so the
    quadratic stays finite for the sphere at infinity) and directions."""
    stl = scene.sph_to_local  # (S, 3, 4)
    o_loc = torch.einsum("sij,rj->rsi", stl[:, :, :3], origin) + stl[None, :, :, 3]
    o_loc = torch.clamp(o_loc, -1e15, 1e15)
    d_loc = torch.einsum("sij,rj->rsi", stl[:, :, :3], direction)
    return o_loc, d_loc


def finalize_hit(scene: Scene, origin, direction, tri_t, tri_id, tri_u, tri_v, t_max=_BIG) -> HitRecord:
    """Fold the spheres into a finished triangle search and derive the
    shading payload (position, normal, material, uv). Split out of
    :func:`ray_cast` for the persistent megakernel, which runs it on lanes
    whose grid traversal just completed."""
    o_loc, d_loc = _sphere_local(scene, origin, direction)
    sh, st = isect.ray_unit_sphere(o_loc, d_loc)
    sh = sh & (scene.sph_mat > 0)[None, :]
    st = torch.where(sh, st, torch.full_like(st, _BIG))
    s_t, sj = torch.min(st, dim=1)

    use_sphere = s_t < tri_t
    best_t = torch.where(use_sphere, s_t, tri_t)
    hit = best_t < t_max

    prim_kind = use_sphere.to(torch.int64)
    prim_id = torch.where(use_sphere, sj, tri_id)

    pos = origin + direction * best_t[:, None]

    safe_tid = torch.clamp(tri_id, min=0)
    tri_n = scene.tri_normal[safe_tid]
    tri_m = scene.tri_mat[safe_tid]

    # sphere normal: the local hit point through to_local^T; misses carry
    # s_t = _BIG, clamped before the local hit point is formed
    s_t_lp = torch.clamp(s_t, max=1e12)
    idx = sj[:, None, None].expand(-1, 1, 3)
    lp = torch.gather(o_loc, 1, idx)[:, 0] + torch.gather(d_loc, 1, idx)[:, 0] * s_t_lp[:, None]
    a_loc = scene.sph_to_local[sj][:, :, :3]
    sph_n = torch.einsum("rji,rj->ri", a_loc, lp)
    sph_n = sph_n / torch.clamp(torch.linalg.norm(sph_n, dim=-1, keepdim=True), min=1e-30)
    sph_m = scene.sph_mat[sj]

    normal = torch.where(use_sphere[:, None], sph_n, tri_n)
    mat_id = torch.where(use_sphere, sph_m, tri_m)
    mat_id = torch.where(hit, mat_id, torch.zeros_like(mat_id))

    # uv: barycentric for triangles, spherical for spheres
    phi = torch.atan2(lp[:, 2], lp[:, 0])
    theta = torch.acos(torch.clamp(lp[:, 1], -1.0 + 1e-6, 1.0 - 1e-6))
    sph_uv = torch.stack([phi / (2 * math.pi) + 0.5, theta / math.pi], dim=-1)
    tri_uv = torch.stack([tri_u, tri_v], dim=-1)
    uv = torch.where(use_sphere[:, None], sph_uv, tri_uv)

    return HitRecord(hit=hit, t=best_t, position=pos, normal=normal, mat_id=mat_id,
                     prim_kind=prim_kind, prim_id=prim_id, uv=uv)


def _any_hit_tris(scene: Scene, o, d, t_max) -> torch.Tensor:
    """(R,) bool: does any triangle block the ray before t_max?
    Moller-Trumbore component-wise in (T_chunk, R) layout."""
    r = o.shape[0]
    ox, oy, oz = (o[:, i][None, :] for i in range(3))
    dx, dy, dz = (d[:, i][None, :] for i in range(3))
    eps_det = 1e-9
    blocked = torch.zeros((r,), dtype=torch.bool, device=o.device)
    n_tri = scene.tri_p0.shape[0]
    for base in range(0, n_tri, _VIS_TRI_CHUNK):
        sl = slice(base, base + _VIS_TRI_CHUNK)
        p0, e1, e2 = scene.tri_p0[sl], scene.tri_e1[sl], scene.tri_e2[sl]
        e1x, e1y, e1z = (e1[:, i][:, None] for i in range(3))
        e2x, e2y, e2z = (e2[:, i][:, None] for i in range(3))
        p0x, p0y, p0z = (p0[:, i][:, None] for i in range(3))
        pv0 = dy * e2z - dz * e2y
        pv1 = dz * e2x - dx * e2z
        pv2 = dx * e2y - dy * e2x
        det = e1x * pv0 + e1y * pv1 + e1z * pv2
        inv = torch.where(torch.abs(det) > eps_det, 1.0 / det, torch.zeros_like(det))
        tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
        u = (tvx * pv0 + tvy * pv1 + tvz * pv2) * inv
        qv0 = tvy * e1z - tvz * e1y
        qv1 = tvz * e1x - tvx * e1z
        qv2 = tvx * e1y - tvy * e1x
        v = (dx * qv0 + dy * qv1 + dz * qv2) * inv
        t = (e2x * qv0 + e2y * qv1 + e2z * qv2) * inv
        hit = ((torch.abs(det) > eps_det) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
               & (t > 0.0) & (t < t_max))
        blocked = blocked | torch.any(hit, dim=0)
    return blocked


def test_visibility(scene: Scene, p1: torch.Tensor, p2: torch.Tensor, eps=1e-4) -> torch.Tensor:
    """True where the segment p1 -> p2 is unobstructed: the ray is shrunk by
    eps at both ends and any hit with t in (0, 1) blocks. A boolean only,
    without the shading payload of :func:`ray_cast`."""
    diff = p2 - p1
    n = diff / torch.clamp(torch.linalg.norm(diff, dim=-1, keepdim=True), min=1e-30)
    o = p1 + n * eps
    d = diff - 2.0 * eps * n
    t_max = 1.0

    if scene.accel is not None:
        from portbench.reference.lf.renderer import accel as accel_mod

        _, tri_id, _, _ = accel_mod.traverse(scene.accel, accel_mod.pack_tris(scene), o, d, t_max)
        tri_blocked = tri_id >= 0
    else:
        tri_blocked = _any_hit_tris(scene, o, d, t_max)

    o_loc, d_loc = _sphere_local(scene, o, d)
    sh, st = isect.ray_unit_sphere(o_loc, d_loc)
    sph_blocked = torch.any(sh & (st < t_max) & (scene.sph_mat > 0)[None, :], dim=1)
    return ~(tri_blocked | sph_blocked)



def tangent_frame(normal: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) world -> tangent rotation with the normal on row 1 (+Y)."""
    a = torch.abs(normal)
    use_x = (a[..., 0] <= a[..., 1]) & (a[..., 0] <= a[..., 2])
    use_y = ~use_x & (a[..., 1] <= a[..., 2])
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=normal.dtype, device=normal.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=normal.dtype, device=normal.device)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=normal.dtype, device=normal.device)
    axis = torch.where(use_x[..., None], ex, torch.where(use_y[..., None], ey, ez))
    x = torch.linalg.cross(normal, axis)
    ok = torch.sum(x * x, dim=-1, keepdim=True) > 1e-24
    x = torch.where(ok, x, ex)
    x = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-30)
    z = torch.linalg.cross(x, normal)
    return torch.stack([x, normal, z], dim=-2)
