"""Uniform-grid ray accelerator with a wavefront 3D-DDA traversal (port of
``libfluid_tpu.renderer.accel``).

Triangles whose cell span exceeds ``max_span`` cells on some axis (walls,
lights, floors) go to a dense "big" list tested by every ray once a cast;
the rest land in per-cell CSR lists built with one stable sort. A
proximity field (the L-inf distance to the nearest occupied cell, capped at
``DIST_CAP``) lets a ray hop through empty space in one iteration.

Differences from the JAX package: indices are int64; ``jnp.argsort`` is a
stable ``torch.sort``, ``segment_sum`` a ``bincount``, ``nonzero(size=...)``
a rank scatter (no host sync), the ``reduce_window`` erosion a
``max_pool3d`` of the negated field (its padding never wins a max, as the
JAX padding of -(2^31 - 1) does not); and :func:`traverse`'s
``while_loop`` is a Python loop that reads its exit flag from the device
every ``loops.TRAVERSE_CHECK_EVERY`` iterations (iterations after the last
live ray change nothing, so the result is the same as testing every
iteration).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from libfluid_tpu_torch.config import resolve_device
from libfluid_tpu_torch.renderer import loops

_BIG = 3.0e38

DIST_CAP = 16  # the largest empty-space hop stored in Accel.dist, in cells
CHUNK = 8  # triangles tested per ray per traversal iteration


class Accel(NamedTuple):
    res: Tuple[int, int, int]  # grid resolution
    lo: torch.Tensor  # (3,) world bbox min
    cell: torch.Tensor  # (3,) cell size per axis
    cell_start: torch.Tensor  # (C+1,) int64 CSR offsets into tri_ids
    tri_ids: torch.Tensor  # (E,) int64 triangle ids, sorted by cell
    big_ids: torch.Tensor  # (B,) int64 large-triangle ids, -1 padded
    big_overflow: torch.Tensor  # () int64, big triangles beyond capacity (should be 0)
    dist: torch.Tensor  # (C,) int64 L-inf distance to the nearest occupied cell, capped

    @property
    def num_cells(self) -> int:
        rx, ry, rz = self.res
        return rx * ry * rz


def _valid_tris(scene) -> torch.Tensor:
    # material 0 is the reserved null/padding material
    return scene.tri_mat > 0


def build(scene, res: Tuple[int, int, int] = (64, 64, 64), big_capacity: int = 128,
          max_span: int = 2, device=None) -> Accel:
    """The uniform grid of `scene`'s triangles, built on `device` (None: the
    CUDA card; ``"cpu"`` on request), where the scene must lie.

    Every small triangle occupies at most (max_span+1)^3 cells, so the entry
    array never truncates; triangles spanning more go to the big list, whose
    ``big_overflow`` is the only signal of truncation: pick `res` so cells
    are no smaller than ~1/max_span of the bulk triangle size (e.g. the
    marching-cubes resolution for a fluid mesh)."""
    device = resolve_device(device)
    if scene.tri_p0.device != device:
        raise ValueError(f"accel.build on {device}: the scene lies on {scene.tri_p0.device}")
    rx, ry, rz = res
    t_cap = scene.tri_p0.shape[0]
    valid = _valid_tris(scene)

    v0 = scene.tri_p0
    v1 = v0 + scene.tri_e1
    v2 = v0 + scene.tri_e2
    tlo = torch.minimum(v0, torch.minimum(v1, v2))
    thi = torch.maximum(v0, torch.maximum(v1, v2))

    lo = torch.amin(torch.where(valid[:, None], tlo, torch.full_like(tlo, _BIG)), dim=0)
    hi = torch.amax(torch.where(valid[:, None], thi, torch.full_like(thi, -_BIG)), dim=0)
    # degenerate/empty guard and an epsilon pad so boundary triangles stay inside
    span = torch.clamp(hi - lo, min=1e-6)
    pad = span * 1e-4
    lo = lo - pad
    resf = torch.tensor([rx, ry, rz], dtype=v0.dtype, device=device)
    cell = (span + 2 * pad) / resf

    resv = torch.tensor([rx, ry, rz], dtype=torch.int64, device=device)
    clo = torch.minimum(torch.clamp(torch.floor((tlo - lo) / cell).long(), min=0), resv - 1)
    chi = torch.minimum(torch.clamp(torch.floor((thi - lo) / cell).long(), min=0), resv - 1)
    span_cells = chi - clo  # >= 0
    small = valid & torch.all(span_cells <= max_span, dim=-1)
    big = valid & ~small

    num_cells = rx * ry * rz
    sentinel = num_cells  # entries sorted past every real cell

    keys = []
    for ox in range(max_span + 1):
        for oy in range(max_span + 1):
            for oz in range(max_span + 1):
                offv = torch.tensor([ox, oy, oz], dtype=torch.int64, device=device)
                c = torch.minimum(clo + offv, resv - 1)
                ok = small & torch.all(offv <= span_cells, dim=-1)
                flat = (c[:, 0] * ry + c[:, 1]) * rz + c[:, 2]
                keys.append(torch.where(ok, flat, torch.full_like(flat, sentinel)))
    key_arr = torch.cat(keys)  # ((max_span+1)^3 T,)
    tid_arr = torch.arange(t_cap, dtype=torch.int64, device=device).repeat(len(keys))

    order = torch.sort(key_arr, stable=True).indices
    tri_ids = tid_arr[order]
    counts = torch.bincount(key_arr, minlength=num_cells + 1)[:num_cells]
    cell_start = torch.cat([torch.zeros((1,), dtype=torch.int64, device=device), torch.cumsum(counts, 0)])

    # the first big_capacity big triangles in id order, -1 padded
    rank = torch.cumsum(big.long(), 0) - 1
    slot = torch.where(big & (rank < big_capacity), rank, torch.full_like(rank, big_capacity))
    big_buf = torch.full((big_capacity + 1,), -1, dtype=torch.int64, device=device)
    big_buf.scatter_(0, slot, torch.where(slot < big_capacity, torch.arange(t_cap, device=device),
                                          torch.full_like(slot, -1)))
    big_idx = big_buf[:big_capacity]
    big_overflow = torch.sum(big.long()) - torch.sum((big_idx >= 0).long())

    # proximity field: DIST_CAP - 1 saturating 3^3 min-erosions of the
    # occupancy (a max pool of the negated field; its padding never wins)
    occ3 = (counts > 0).reshape(1, 1, rx, ry, rz)
    d3 = torch.where(occ3, 0.0, float(DIST_CAP))
    for _ in range(DIST_CAP - 1):
        eroded = -F.max_pool3d(-d3, 3, stride=1, padding=1)
        d3 = torch.minimum(d3, eroded + 1.0)

    return Accel(res=tuple(res), lo=lo, cell=cell, cell_start=cell_start, tri_ids=tri_ids,
                 big_ids=big_idx, big_overflow=big_overflow, dist=d3.reshape(-1).long())


def _moller_trumbore(o, d, p0, e1, e2, eps=1e-9):
    """Batched ray-triangle test (broadcasting): (hit, t, u, v)."""
    o, d, p0, e1, e2 = torch.broadcast_tensors(o, d, p0, e1, e2)
    pvec = torch.linalg.cross(d, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    inv = torch.where(torch.abs(det) > eps, 1.0 / det, torch.zeros_like(det))
    tvec = o - p0
    u = torch.sum(tvec * pvec, dim=-1) * inv
    qvec = torch.linalg.cross(tvec, e1)
    v = torch.sum(d * qvec, dim=-1) * inv
    t = torch.sum(e2 * qvec, dim=-1) * inv
    hit = (torch.abs(det) > eps) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return hit, t, u, v


class TravState(NamedTuple):
    """Per-ray DDA state, exposed so the persistent megakernel can interleave
    single traversal steps with shading and respawn."""

    active: torch.Tensor  # (R,) still traversing
    cell3: torch.Tensor  # (R, 3)
    t_next: torch.Tensor  # (R, 3)
    t_cur: torch.Tensor  # (R,)
    start: torch.Tensor  # (R,)
    cnt: torch.Tensor  # (R,)
    dist: torch.Tensor  # (R,)
    k: torch.Tensor  # (R,) triangles tested so far in the current cell
    best_t: torch.Tensor
    best_id: torch.Tensor
    best_u: torch.Tensor
    best_v: torch.Tensor


def _fetch(accel: Accel, c3):
    rx, ry, rz = accel.res
    flat = (c3[:, 0] * ry + c3[:, 1]) * rz + c3[:, 2]
    flat = torch.clamp(flat, 0, rx * ry * rz - 1)
    s = accel.cell_start[flat]
    e = accel.cell_start[flat + 1]
    return s, e - s, accel.dist[flat]


def _take(x, j):
    return torch.gather(x, 1, j[:, None])[:, 0]


def init_state(accel: Accel, tri_pack: torch.Tensor, origin: torch.Tensor, direction: torch.Tensor,
               t_max) -> TravState:
    """Fresh traversal state: the big-triangle list tested once, the ray
    clipped against the grid box, the DDA at the entry cell."""
    rx, ry, rz = accel.res
    r = origin.shape[0]
    dtype, dev = origin.dtype, origin.device
    resv = torch.tensor([rx, ry, rz], dtype=torch.int64, device=dev)

    best_t = torch.full((r,), float(t_max), dtype=dtype, device=dev)
    best_id = torch.full((r,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((r,), dtype=dtype, device=dev)
    best_v = torch.zeros((r,), dtype=dtype, device=dev)

    # big triangles: one pass over the (small, static) list
    bids = accel.big_ids
    bt = tri_pack[torch.clamp(bids, 0, tri_pack.shape[0] - 1)]  # (B, 9)
    hit, t, u, v = _moller_trumbore(origin[:, None], direction[:, None], bt[None, :, 0:3],
                                    bt[None, :, 3:6], bt[None, :, 6:9])
    hit = hit & (bids >= 0)[None, :] & (t < best_t[:, None])
    t = torch.where(hit, t, torch.full_like(t, _BIG))
    tj, j = torch.min(t, dim=1)
    closer = tj < best_t
    best_id = torch.where(closer, bids[j], best_id)
    best_u = torch.where(closer, _take(u, j), best_u)
    best_v = torch.where(closer, _take(v, j), best_v)
    best_t = torch.where(closer, tj, best_t)

    # DDA setup
    inv_d = torch.where(torch.abs(direction) > 1e-30, 1.0 / direction, torch.full_like(direction, _BIG))
    box_lo = accel.lo
    box_hi = accel.lo + accel.cell * resv.to(dtype)
    t_lo = (box_lo - origin) * inv_d
    t_hi = (box_hi - origin) * inv_d
    t_near = torch.amax(torch.minimum(t_lo, t_hi), dim=-1)
    t_far = torch.amin(torch.maximum(t_lo, t_hi), dim=-1)
    t_enter = torch.clamp(t_near, min=0.0)
    misses_box = (t_far < t_enter) | (t_enter >= best_t)

    p = origin + direction * (t_enter[:, None] + 1e-7)
    cellf = (p - box_lo) / accel.cell
    cell3 = torch.minimum(torch.clamp(torch.floor(cellf).long(), min=0), resv - 1)
    step = torch.sign(direction).long()
    next_bound = box_lo + (cell3 + (step > 0).long()).to(dtype) * accel.cell
    t_next = torch.where(step == 0, torch.full_like(inv_d, _BIG), (next_bound - origin) * inv_d)
    start0, cnt0, dist0 = _fetch(accel, cell3)
    return TravState(active=~misses_box, cell3=cell3, t_next=t_next, t_cur=t_enter, start=start0,
                     cnt=cnt0, dist=dist0, k=torch.zeros((r,), dtype=torch.int64, device=dev),
                     best_t=best_t, best_id=best_id, best_u=best_u, best_v=best_v)


def step_state(accel: Accel, tri_pack: torch.Tensor, origin: torch.Tensor, direction: torch.Tensor,
               st: TravState) -> TravState:
    """One lockstep traversal iteration: test a CHUNK of the current cell's
    triangles and advance the rays whose cell is exhausted; through empty
    space hop dist - 1 cells at once (an L-inf ball the distance field
    guarantees empty) and re-derive the DDA state from the landing point."""
    rx, ry, rz = accel.res
    dtype, dev = origin.dtype, origin.device
    resv = torch.tensor([rx, ry, rz], dtype=torch.int64, device=dev)
    e_cap = accel.tri_ids.shape[0]
    box_lo = accel.lo
    inv_d = torch.where(torch.abs(direction) > 1e-30, 1.0 / direction, torch.full_like(direction, _BIG))
    step = torch.sign(direction).long()
    t_delta = torch.abs(accel.cell * inv_d)
    t_min_delta = torch.amin(torch.where(step == 0, torch.full_like(t_delta, _BIG), t_delta), dim=-1)

    (active, cell3, t_next, t_cur, start, cnt, dist, k, best_t, best_id, best_u, best_v) = st

    testing = active & (k < cnt)

    # test a chunk of the current cell's triangles
    idx = start[:, None] + k[:, None] + torch.arange(CHUNK, dtype=torch.int64, device=dev)[None]
    in_list = testing[:, None] & (idx < (start + cnt)[:, None])
    ids = accel.tri_ids[torch.clamp(idx, 0, e_cap - 1)]  # (R, CHUNK)
    rows = tri_pack[torch.where(in_list, ids, torch.full_like(ids, tri_pack.shape[0] - 1))]  # (R, CHUNK, 9)
    hit, t, u, v = _moller_trumbore(origin[:, None], direction[:, None], rows[..., 0:3], rows[..., 3:6],
                                    rows[..., 6:9])
    hit = hit & in_list & (t < best_t[:, None])
    tm = torch.where(hit, t, torch.full_like(t, _BIG))
    tj, j = torch.min(tm, dim=1)
    closer = tj < best_t
    best_id = torch.where(closer, _take(ids, j), best_id)
    best_u = torch.where(closer, _take(u, j), best_u)
    best_v = torch.where(closer, _take(v, j), best_v)
    best_t = torch.where(closer, tj, best_t)
    k = torch.where(testing, k + CHUNK, k)

    # advance every ray whose cell is exhausted
    stepping = active & (k >= cnt)
    t_exit, axis = torch.min(t_next, dim=-1)
    # the nearest hit is confirmed once the current cell lies past it
    finished = stepping & (t_exit >= best_t)

    # a single-cell DDA step
    onehot = F.one_hot(axis, 3)
    new_cell = cell3 + onehot * step
    oob = torch.any((new_cell < 0) | (new_cell >= resv), dim=-1)
    finished = finished | (stepping & oob)
    move = stepping & ~finished

    # an empty-space hop through the proximity field
    jump = move & (dist >= 2)
    t_land = t_cur + (dist - 1).to(dtype) * t_min_delta + 1e-6
    p_land = origin + direction * t_land[:, None]
    c3_j = torch.floor((p_land - box_lo) / accel.cell).long()
    nb_j = box_lo + (c3_j + (step > 0).long()).to(dtype) * accel.cell
    tn_j = torch.where(step == 0, torch.full_like(nb_j, _BIG), (nb_j - origin) * inv_d)
    oob_j = torch.any((c3_j < 0) | (c3_j >= resv), dim=-1)
    finished = finished | (jump & oob_j)
    jump = jump & ~oob_j
    move = move & ~jump

    cell3 = torch.where(jump[:, None], c3_j, torch.where(move[:, None], new_cell, cell3))
    t_next = torch.where(jump[:, None], tn_j,
                         torch.where(move[:, None], t_next + onehot.to(dtype) * t_delta, t_next))
    t_cur = torch.where(jump, t_land, torch.where(move, t_exit, t_cur))
    moved = move | jump
    s2, c2, d2 = _fetch(accel, cell3)
    start = torch.where(moved, s2, start)
    cnt = torch.where(moved, c2, cnt)
    dist = torch.where(moved, d2, dist)
    k = torch.where(moved, torch.zeros_like(k), k)
    active = active & ~finished

    return TravState(active, cell3, t_next, t_cur, start, cnt, dist, k, best_t, best_id, best_u, best_v)


def traverse(accel: Accel, tri_pack: torch.Tensor, origin: torch.Tensor, direction: torch.Tensor,
             t_max, max_iters: Optional[int] = None):
    """Nearest triangle per ray: (t, tri_id, u, v), t == t_max and tri_id ==
    -1 for misses; t in units of |direction|. At most `max_iters` iterations
    (default 2 (rx + ry + rz) + 64), the exit flag read every
    ``loops.TRAVERSE_CHECK_EVERY``."""
    rx, ry, rz = accel.res
    if max_iters is None:
        max_iters = 2 * (rx + ry + rz) + 64
    st = init_state(accel, tri_pack, origin, direction, t_max)
    for it in range(max_iters):
        if it % loops.TRAVERSE_CHECK_EVERY == 0 and not loops.flag(st.active.any()):
            break
        st = step_state(accel, tri_pack, origin, direction, st)
    return st.best_t, st.best_id, st.best_u, st.best_v


def pack_tris(scene) -> torch.Tensor:
    """(T+1, 9) p0|e1|e2 rows; the last row is a degenerate, never-hit
    triangle for masked lanes."""
    pack = torch.cat([scene.tri_p0, scene.tri_e1, scene.tri_e2], dim=1)
    return torch.cat([pack, torch.zeros((1, 9), dtype=pack.dtype, device=pack.device)], dim=0)
