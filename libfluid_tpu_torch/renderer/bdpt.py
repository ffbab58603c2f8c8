"""Bidirectional path tracer as a fixed-depth wavefront with MIS (port of
``libfluid_tpu.renderer.bdpt``).

Per camera ray it traces a camera subpath and a light subpath, connects
every (s, t) prefix pair (direct emission hits, s = 0; the light point
itself, s = 1; generic connections with a geometry term and a visibility
ray) and weighs each strategy with the balance heuristic, computed by a
pdf-ratio sweep over the subpaths' per-vertex pdfs in area measure.

Variable path lengths are fixed-capacity vertex arrays with validity masks,
built by a loop over bounces that runs every bounce. Every (camera index i,
light index j) strategy is one entry of a pair axis, a batch dimension:
vertex i and j are gathered with index tensors, the MIS walk over depth
runs once, masked, for all pairs, and the connections' visibility rays are
cast in chunks of ``2^18 // R`` pairs (which bounds the brute-force
intersector's temporaries).

Conventions:
- camera vertices x1..xT (x0 = the pinhole) live at array index i = 0..T-1;
  strategy t counts camera vertices *including* the pinhole, so the strategy
  connecting at array index i has t = i + 2.
- light vertices y0..y_{S-1}; in MIS space index j is vertex y_j and the
  strategy connecting at y_j has s = j + 1 (s = 0: no light vertex).
- strategies with t < 2 (light rays hitting the lens) are not sampled and
  are therefore excluded from every balance-heuristic denominator.
- area lights emit from their geometric-normal side with a cosine
  distribution.

Random numbers come from a provider's bidirectional stream
(:mod:`libfluid_tpu_torch.renderer.draws`, ``bdpt``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from libfluid_tpu_torch.config import RenderConfig
from libfluid_tpu_torch.math import warping
from libfluid_tpu_torch.renderer import draws as draws_mod
from libfluid_tpu_torch.renderer import intersect, materials
from libfluid_tpu_torch.renderer.scene import Scene

_RAY_OFFSET = 1e-3
_EPS = 1e-8
_VIS_RAYS = 1 << 18  # connection rays a visibility cast


class Subpath(NamedTuple):
    """Per-ray vertex arrays, depth-major: every field is (D, R, ...)."""

    pos: torch.Tensor  # (D, R, 3)
    normal: torch.Tensor  # (D, R, 3) unit geometric normal
    wo: torch.Tensor  # (D, R, 3) unit direction toward the predecessor
    mat_id: torch.Tensor  # (D, R)
    uv: torch.Tensor  # (D, R, 2) surface uv (textured channels)
    valid: torch.Tensor  # (D, R)
    delta: torch.Tensor  # (D, R) bsdf at this vertex is specular
    beta: torch.Tensor  # (D, R, 3) throughput arriving at this vertex
    pdf_fwd: torch.Tensor  # (D, R) area pdf of generating this vertex
    pdf_rev: torch.Tensor  # (D, R) area pdf of re-generating it from its successor
    start_rev: torch.Tensor  # (R,) area pdf of re-generating the *start point*
    # (camera / light sample) from the first vertex


def _dir_and_dist2(a, b):
    """Unit direction a->b and squared distance, guarded."""
    d = b - a
    d2 = torch.clamp(torch.sum(d * d, dim=-1), min=_EPS)
    return d * torch.rsqrt(d2)[..., None], d2


def _to_area(pdf_dir, cos_at, dist2):
    """Solid-angle pdf at the source -> area pdf at the destination."""
    return pdf_dir * torch.abs(cos_at) / dist2


def _tangent(frame, v):
    return torch.einsum("...ij,...j->...i", frame, v)


def _from_tangent(frame, v):
    return torch.einsum("...ji,...j->...i", frame, v)


def trace_subpath(scene: Scene, o0, d0, beta0, pdf_dir0, prev_pos, prev_normal, draw, depth: int,
                  mode: int) -> Subpath:
    """March `depth` bounces from (o0, d0), every bounce masked. `draw(k, r,
    device)` gives bounce k's (r, 2) BSDF uniforms; `pdf_dir0` is the
    solid-angle pdf of d0 at the start point; `prev_*` describe that start
    point (camera pinhole or light sample) so its reverse pdf can be
    produced by the first bounce."""
    r, dev = o0.shape[0], o0.device
    o = o0
    d = d0 / torch.clamp(torch.linalg.norm(d0, dim=-1, keepdim=True), min=1e-30)
    beta, pdf_dir, p_pos, p_nrm = beta0, pdf_dir0, prev_pos, prev_normal
    alive = torch.ones((r,), dtype=torch.bool, device=dev)
    out = {k: [] for k in ("pos", "normal", "wo", "mat_id", "uv", "valid", "delta", "beta", "pdf_fwd",
                           "pdf_rev_prev")}
    for k in range(depth):
        rec = intersect.ray_cast(scene, o, d)
        valid = alive & rec.hit

        to_v, d2 = _dir_and_dist2(p_pos, rec.position)
        pdf_fwd = _to_area(pdf_dir, torch.sum(rec.normal * to_v, dim=-1), d2)

        frame = intersect.tangent_frame(rec.normal)
        win = _tangent(frame, -d)
        samp = materials.sample_bsdf(scene.materials, rec.mat_id, win, draw(k, r, dev), mode, uv=rec.uv)
        new_d = _from_tangent(frame, samp.direction)

        # reverse pdf of the *previous* vertex: this vertex's bsdf sampling
        # the direction back toward it, in area measure at the previous point
        p_rev_dir = materials.pdf_bsdf(scene.materials, rec.mat_id, samp.direction, win)
        to_prev, pd2 = _dir_and_dist2(rec.position, p_pos)
        pdf_rev_prev = _to_area(p_rev_dir, torch.sum(p_nrm * to_prev, dim=-1), pd2)
        pdf_rev_prev = torch.where(valid, pdf_rev_prev, torch.zeros_like(pdf_rev_prev))

        atten = samp.reflectance * (torch.abs(samp.direction[..., 1])
                                    / torch.clamp(samp.pdf, min=1e-12))[..., None]
        beta_next = beta * atten
        off = torch.where(samp.direction[..., 1] > 0.0, 1.0, -1.0).to(o.dtype)
        new_o = rec.position + rec.normal * (off * _RAY_OFFSET)[:, None]

        out["pos"].append(rec.position)
        out["normal"].append(rec.normal)
        out["wo"].append(-d)
        out["mat_id"].append(torch.where(valid, rec.mat_id, torch.zeros_like(rec.mat_id)))
        out["uv"].append(rec.uv)
        out["valid"].append(valid)
        out["delta"].append(samp.is_delta & valid)
        out["beta"].append(beta)
        out["pdf_fwd"].append(torch.where(valid, pdf_fwd, torch.zeros_like(pdf_fwd)))
        out["pdf_rev_prev"].append(pdf_rev_prev)

        alive_next = valid & (samp.pdf > 1e-12) & (torch.amax(beta_next, dim=-1) > 1e-9)
        v3 = valid[:, None]
        o = torch.where(v3, new_o, o)
        d = torch.where(v3, new_d, d)
        beta = torch.where(v3, beta_next, beta)
        pdf_dir = torch.where(valid, samp.pdf, pdf_dir)
        p_pos = torch.where(v3, rec.position, p_pos)
        p_nrm = torch.where(v3, rec.normal, p_nrm)
        alive = alive_next
    st = {k: torch.stack(v) for k, v in out.items()}
    # pdf_rev of vertex i is produced by bounce i+1 (its successor); the
    # first bounce's value is the reverse pdf of the start point
    rev = torch.cat([st["pdf_rev_prev"][1:], torch.zeros((1, r), dtype=o0.dtype, device=dev)])
    return Subpath(pos=st["pos"], normal=st["normal"], wo=st["wo"], mat_id=st["mat_id"], uv=st["uv"],
                   valid=st["valid"], delta=st["delta"], beta=st["beta"], pdf_fwd=st["pdf_fwd"],
                   pdf_rev=rev, start_rev=st["pdf_rev_prev"][0])


class LightSample(NamedTuple):
    pos: torch.Tensor  # (R, 3)
    normal: torch.Tensor  # (R, 3)
    emission: torch.Tensor  # (R, 3)
    pdf_area: torch.Tensor  # (R,)
    valid: torch.Tensor  # (R,)
    uv: torch.Tensor  # (R, 2) barycentric uv of the sampled point


def sample_light_point(scene: Scene, stream, which: int, count: int, r: int) -> LightSample:
    """Area-weighted light-triangle pick and a uniform point on it, for
    ``count * r`` rows (set-major): `which` 0 is y0, 1 the s = 1 points.
    Area-weighted picking gives pdf_area = 1/total_area for every point."""
    area = torch.where(scene.light_mask, scene.light_area, torch.zeros_like(scene.light_area))
    total = torch.sum(area)
    idx, xi = stream.light_point(which, area, count, r, scene.device)
    tri = scene.light_tri[idx]
    su = torch.sqrt(xi[:, 0])
    b1 = 1.0 - su
    b2 = xi[:, 1] * su
    p = scene.tri_p0[tri] + scene.tri_e1[tri] * b1[:, None] + scene.tri_e2[tri] * b2[:, None]
    uv = torch.stack([b1, b2], dim=-1)
    n = count * r
    return LightSample(
        pos=p,
        normal=scene.tri_normal[tri],
        emission=materials.emission_at(scene.materials, scene.tri_mat[tri], uv),
        pdf_area=torch.ones((n,), dtype=p.dtype, device=p.device) / torch.clamp(total, min=1e-30),
        valid=(total > 0.0).expand(n),
        uv=uv,
    )


def _chain_weight(fwd, rev, delta, idx, rev_last, rev_prev, lo: int):
    """One chain's sum of pdf ratios for pairs (P,) connecting at chain
    index `idx` (P,): the two junction-adjacent reverse pdfs substituted,
    the walk outward from the junction as a reversed cumprod masked to
    positions <= idx, each competing strategy counted where both vertices
    flanking its connection edge are non-delta and its position >= `lo`.
    `fwd`, `rev`, `delta` (D, R); `rev_last`, `rev_prev` (P, R)."""
    d = fwd.shape[0]
    k = torch.arange(d, device=fwd.device)[None, :, None]
    at = idx[:, None, None]
    rv = torch.where(k == at, rev_last[:, None], torch.where(k == at - 1, rev_prev[:, None], rev[None]))
    ratio = rv / torch.where(fwd > _EPS, fwd, torch.ones_like(fwd))[None]
    rm = torch.where(k <= at, ratio, torch.ones_like(ratio))
    suffix = torch.flip(torch.cumprod(torch.flip(rm, (1,)), dim=1), (1,))  # prod_{m..idx} ratio
    delta_prev = torch.cat([torch.zeros_like(delta[:1]), delta[:-1]])
    conn = (~delta) & (~delta_prev)
    keep = (k >= lo) & (k <= at) & conn[None]
    return torch.sum(torch.where(keep, suffix, torch.zeros_like(suffix)), dim=1)


def _mis_weight_v(cam_fwd, cam_rev, cam_delta, i, rev_cam_last, rev_cam_prev, light=None):
    """Balance-heuristic weights (P, R) of the strategies connecting camera
    array index ``i`` (P,) with light MIS index j (index 0 = the light point
    y0; ``light=None`` for s = 0 emission hits, else (l_fwd, l_rev, l_delta,
    j, rev_lig_last, rev_lig_prev) with (S, R) chain arrays and j (P,)):
    the reference's pdf-ratio sweep with scoped reassignment, for every pair
    at once."""
    total = 1.0 + _chain_weight(cam_fwd, cam_rev, cam_delta, i, rev_cam_last, rev_cam_prev, 1)
    if light is not None:
        l_fwd, l_rev, l_delta, j, rev_lig_last, rev_lig_prev = light
        total = total + _chain_weight(l_fwd, l_rev, l_delta, j, rev_lig_last, rev_lig_prev, 0)
    return 1.0 / total


def trace_rays(scene: Scene, origins: torch.Tensor, directions: torch.Tensor, rng, cfg: RenderConfig,
               with_stats: bool = False):
    """BDPT radiance estimate (R, 3) for a batch of camera rays, with
    `with_stats` also the number of rays actually cast (subpath casts on
    alive lanes, the light points and the visibility rays of strategies
    that needed one; a device tensor). `rng` is a ``torch.Generator`` or a
    bidirectional stream (:func:`draws.as_bdpt_stream`)."""
    stream = draws_mod.as_bdpt_stream(rng)
    r, dev, dtype = origins.shape[0], origins.device, origins.dtype
    t_depth, s_depth = cfg.max_camera_bounces, cfg.max_light_bounces

    # --- camera subpath --------------------------------------------------------
    d0n = directions / torch.clamp(torch.linalg.norm(directions, dim=-1, keepdim=True), min=1e-30)
    cam = trace_subpath(scene, origins, directions, torch.ones((r, 3), dtype=dtype, device=dev),
                        torch.ones((r,), dtype=dtype, device=dev),  # pinhole: t<2 excluded, cancels
                        origins, d0n, stream.camera, t_depth, materials.RADIANCE)

    # --- light subpath: y0 on a light, cosine-emitted continuation ------------
    y0 = sample_light_point(scene, stream, 0, 1, r)
    frame0 = intersect.tangent_frame(y0.normal)
    dloc = warping.unit_hemisphere_cosine_from_unit_square(stream.emit(r, dev))  # z-up
    d_tan = torch.stack([dloc[..., 0], dloc[..., 2], dloc[..., 1]], dim=-1)
    d0 = _from_tangent(frame0, d_tan)
    cos0 = torch.abs(d_tan[..., 1])
    pdf_dir0 = torch.clamp(cos0 / math.pi, min=1e-12)

    beta_y0 = y0.emission / y0.pdf_area[:, None]
    lig = None
    if s_depth >= 2:
        lig = trace_subpath(scene, y0.pos + y0.normal * _RAY_OFFSET, d0, beta_y0 * (cos0 / pdf_dir0)[:, None],
                            pdf_dir0, y0.pos, y0.normal, stream.light, s_depth - 1, materials.IMPORTANCE)
        lig = lig._replace(valid=lig.valid & y0.valid[None, :])

    # MIS chain arrays (camera: (T, R); light: (S, R), index 0 = y0)
    cam_fwd, cam_rev, cam_delta = cam.pdf_fwd, cam.pdf_rev, cam.delta
    if lig is not None:
        l_fwd = torch.cat([y0.pdf_area[None], lig.pdf_fwd])
        l_rev = torch.cat([lig.start_rev[None], lig.pdf_rev])
        l_delta = torch.cat([torch.zeros((1, r), dtype=torch.bool, device=dev), lig.delta])
    else:
        l_fwd = y0.pdf_area[None]
        l_rev = torch.zeros((1, r), dtype=dtype, device=dev)
        l_delta = torch.zeros((1, r), dtype=torch.bool, device=dev)

    # ========== s = 0: camera path hits an emitter, every depth at once =======
    emis = materials.emission_at(scene.materials, cam.mat_id.reshape(-1),
                                 cam.uv.reshape(-1, 2)).reshape(t_depth, r, 3)
    is_emitter = torch.amax(emis, dim=-1) > 0.0
    front = torch.sum(cam.normal * cam.wo, dim=-1) > 0.0
    ok0 = cam.valid & is_emitter & front
    contrib0 = cam.beta * emis

    rev_last0 = y0.pdf_area[None].expand(t_depth, r)
    pos_prev = torch.cat([cam.pos[:1], cam.pos[:-1]])
    nrm_prev = torch.cat([cam.normal[:1], cam.normal[:-1]])
    to_prev0, d2_0 = _dir_and_dist2(cam.pos, pos_prev)
    cos_l0 = torch.sum(cam.normal * to_prev0, dim=-1)
    rev_prev0 = _to_area(torch.abs(cos_l0) / math.pi, torch.sum(nrm_prev * to_prev0, dim=-1), d2_0)
    has_prev = (torch.arange(t_depth, device=dev) >= 1)[:, None]
    rev_prev0 = torch.where(has_prev, rev_prev0, torch.zeros_like(rev_prev0))
    w0 = _mis_weight_v(cam_fwd, cam_rev, cam_delta, torch.arange(t_depth, device=dev), rev_last0, rev_prev0)
    radiance = torch.sum(torch.where(ok0[..., None], w0[..., None] * contrib0, torch.zeros_like(contrib0)),
                         dim=0)

    # ========== s >= 1, t >= 2 connections ====================================
    # s = 1 draws a FRESH light point per camera vertex; with area-weighted
    # picking its pdf is the constant 1/total_area, so the MIS chain's y0
    # entry needs no substitution
    y1 = LightSample(*(a.reshape((t_depth, r) + a.shape[1:]) for a in
                       sample_light_point(scene, stream, 1, t_depth, r)))

    # the pair axis: every (camera index i, light MIS index j), i-major
    i_arr = torch.arange(t_depth, device=dev).repeat_interleave(s_depth)
    j_arr = torch.arange(s_depth, device=dev).repeat(t_depth)
    npairs = t_depth * s_depth
    j0 = (j_arr == 0)[:, None]  # (P, 1)
    im1 = torch.clamp(i_arr - 1, min=0)
    jm1 = torch.clamp(j_arr - 1, min=0)

    xc, cn, cwo = cam.pos[i_arr], cam.normal[i_arr], cam.wo[i_arr]
    cmat, cuv, cvalid = cam.mat_id[i_arr], cam.uv[i_arr], cam.valid[i_arr]
    cdelta, cbeta = cam.delta[i_arr], cam.beta[i_arr]
    cpos_prev, cnrm_prev = cam.pos[im1], cam.normal[im1]

    y1p, y1n, y1e = y1.pos[i_arr], y1.normal[i_arr], y1.emission[i_arr]
    y1pd, y1v = y1.pdf_area[i_arr], y1.valid[i_arr]
    if lig is not None:
        lp, ln, lwo, lmat = lig.pos[jm1], lig.normal[jm1], lig.wo[jm1], lig.mat_id[jm1]
        luv, lvalid, ldel, lbeta = lig.uv[jm1], lig.valid[jm1], lig.delta[jm1], lig.beta[jm1]
    else:
        lp, ln, lwo, lmat = y1p, y1n, y1n, torch.zeros_like(cmat)
        luv = torch.zeros(cuv.shape, dtype=dtype, device=dev)
        lvalid = ldel = torch.zeros(cvalid.shape, dtype=torch.bool, device=dev)
        lbeta = torch.zeros(cbeta.shape, dtype=dtype, device=dev)

    j03 = j0[..., None]
    yl = torch.where(j03, y1p, lp)
    nl = torch.where(j03, y1n, ln)
    vall = torch.where(j0, y1v, lvalid)
    dl = ~j0 & ldel
    ok = cvalid & vall & ~cdelta & ~dl

    d_cl, d2 = _dir_and_dist2(xc, yl)  # camera vertex -> light vertex
    cos_c = torch.sum(cn * d_cl, dim=-1)
    cos_l = torch.sum(nl * -d_cl, dim=-1)
    geom = torch.abs(cos_c) * torch.abs(cos_l) / d2

    # camera-junction bsdf: f, forward pdf toward the light, and the reverse
    # pdf back toward x_{t-2}
    frame_c = intersect.tangent_frame(cn)
    win_c = _tangent(frame_c, cwo)
    wout_c = _tangent(frame_c, d_cl)
    f_c = materials.eval_bsdf(scene.materials, cmat, win_c, wout_c, uv=cuv)
    pdf_c_fwd = materials.pdf_bsdf(scene.materials, cmat, win_c, wout_c)
    pdf_c_back = materials.pdf_bsdf(scene.materials, cmat, wout_c, win_c)
    to_prev, pd2 = _dir_and_dist2(xc, cpos_prev)
    rev_cam_prev = _to_area(pdf_c_back, torch.sum(cnrm_prev * to_prev, dim=-1), pd2)
    rev_cam_prev = torch.where((i_arr >= 1)[:, None], rev_cam_prev, torch.zeros_like(rev_cam_prev))
    rev_lig_last = _to_area(pdf_c_fwd, cos_l, d2)  # x samples y_j

    # s = 1: connect to the emitter itself; one-sided cosine emission
    emit_ok = (cos_l > 0.0).to(dtype)
    beta_y1 = y1e / y1pd[..., None]
    contrib_j0 = cbeta * f_c * (geom * emit_ok)[..., None] * beta_y1
    rev_cam_last_j0 = _to_area(torch.clamp(cos_l, min=0.0) / math.pi, cos_c, d2)

    if lig is not None:
        # s >= 2: a bsdf junction at light vertex y_j
        frame_l = intersect.tangent_frame(nl)
        win_l = _tangent(frame_l, lwo)
        wout_l = _tangent(frame_l, -d_cl)
        f_l = materials.eval_bsdf(scene.materials, lmat, win_l, wout_l, uv=luv)
        pdf_l_fwd = materials.pdf_bsdf(scene.materials, lmat, win_l, wout_l)
        pdf_l_back = materials.pdf_bsdf(scene.materials, lmat, wout_l, win_l)
        contrib_j1 = cbeta * f_c * geom[..., None] * f_l * lbeta
        rev_cam_last_j1 = _to_area(pdf_l_fwd, cos_c, d2)
        jm2 = torch.clamp(j_arr - 2, min=0)
        first = (j_arr <= 1)[:, None, None]
        prev_pos_l = torch.where(first, y0.pos[None], lig.pos[jm2])
        prev_nrm_l = torch.where(first, y0.normal[None], lig.normal[jm2])
        to_prev_l, ld2 = _dir_and_dist2(yl, prev_pos_l)
        rev_lig_prev_j1 = _to_area(pdf_l_back, torch.sum(prev_nrm_l * to_prev_l, dim=-1), ld2)
        contrib = torch.where(j03, contrib_j0, contrib_j1)
        rev_cam_last = torch.where(j0, rev_cam_last_j0, rev_cam_last_j1)
        rev_lig_prev = torch.where(j0, torch.zeros_like(rev_lig_prev_j1), rev_lig_prev_j1)
    else:
        contrib = contrib_j0
        rev_cam_last = rev_cam_last_j0
        rev_lig_prev = torch.zeros_like(rev_cam_last_j0)

    w = _mis_weight_v(cam_fwd, cam_rev, cam_delta, i_arr, rev_cam_last, rev_cam_prev,
                      light=(l_fwd, l_rev, l_delta, j_arr, rev_lig_last, rev_lig_prev))
    ok = ok & (torch.amax(contrib, dim=-1) > 0.0)

    # visibility of every connection, pairs folded into the ray axis in
    # chunks of `chunk` pairs
    chunk = max(1, min(npairs, _VIS_RAYS // max(r, 1)))
    vis = torch.cat([
        intersect.test_visibility(scene, xc[a:a + chunk].reshape(-1, 3),
                                  yl[a:a + chunk].reshape(-1, 3)).reshape(-1, r)
        for a in range(0, npairs, chunk)
    ])

    need_vis = ok
    ok = ok & vis
    radiance = radiance + torch.sum(torch.where(ok[..., None], w[..., None] * contrib,
                                                torch.zeros_like(contrib)), dim=0)
    if with_stats:
        cast = (torch.sum(cam.valid) + (torch.sum(lig.valid) if lig is not None else 0)
                + torch.sum(y0.valid) + torch.sum(need_vis))
        return radiance, cast
    return radiance
