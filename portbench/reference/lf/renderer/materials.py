"""Materials and BSDF evaluation and sampling over flat tables (port of
``libfluid_tpu.renderer.materials``).

A table holds a kind id and parameters per material; the batched sample,
evaluate and pdf functions compute all three BSDF kinds elementwise and
select by kind. Conventions: tangent space with the shading normal on +Y,
directions pointing away from the surface; Lambertian is double-sided with
cosine sampling; the perfect mirror divides by |cos|; dielectric
transmission splits reflection and refraction by Fresnel, handles total
internal reflection and multiplies eta^2 in radiance transport.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from portbench.reference.lf.math import warping

LAMBERTIAN = 0
SPECULAR_REFLECTION = 1
SPECULAR_TRANSMISSION = 2

# transport modes
RADIANCE = 0
IMPORTANCE = 1

_PI = math.pi


class MaterialTable(NamedTuple):
    """Flat material parameters; index 0 is the reserved "null" material
    (black lambertian, no emission) of padding primitives. A channel's value
    is ``modulation * sample(texture, uv)``; texture 0 is a 1x1 white texel,
    so "no texture" needs no branch."""

    kind: torch.Tensor  # (M,) int64
    albedo: torch.Tensor  # (M, 3)
    ior: torch.Tensor  # (M,)
    emission: torch.Tensor  # (M, 3)
    albedo_tex: Optional[torch.Tensor] = None  # (M,) int64, 0 = untextured
    emission_tex: Optional[torch.Tensor] = None  # (M,) int64
    textures: Optional[torch.Tensor] = None  # (NT, TH, TW, 3); texture 0 = white
    tex_hw: Optional[torch.Tensor] = None  # (NT, 2) int64 true (h, w) per texture


def sample_texture(textures, tex_hw, tex_id, uv):
    """Bilinear texture sample: uv wraps, texel centres at (i + 0.5) / n,
    edge clamp. `tex_id` (...,) integer, `uv` (..., 2) with u = x (width),
    v = y (height)."""
    hw = tex_hw[tex_id].to(uv.dtype)  # (..., 2) true (h, w)
    size = torch.stack([hw[..., 1], hw[..., 0]], dim=-1)  # (w, h) in uv order
    uvw = uv - torch.floor(uv)
    p = uvw * size + 0.5
    ip = torch.floor(p)
    frac = p - ip
    tl = torch.clamp(ip - 1.0, min=0.0).long()
    br = torch.minimum(ip, size - 1.0).long()
    x0, y0 = tl[..., 0], tl[..., 1]
    x1, y1 = br[..., 0], br[..., 1]

    def at(yy, xx):
        return textures[tex_id, yy, xx]

    p_tl = at(y0, x0)
    p_tr = at(y0, x1)
    p_bl = at(y1, x0)
    p_br = at(y1, x1)
    fx = frac[..., 0:1]
    fy = frac[..., 1:2]
    top = p_tl + (p_tr - p_tl) * fx
    bot = p_bl + (p_br - p_bl) * fx
    return top + (bot - top) * fy


def _channel(table: MaterialTable, base, tex_ids, mat_id, uv):
    if uv is None or table.textures is None or table.textures.shape[0] <= 1:
        return base
    return base * sample_texture(table.textures, table.tex_hw, tex_ids[mat_id], uv)


def albedo_at(table: MaterialTable, mat_id, uv=None):
    """The albedo channel's value."""
    return _channel(table, table.albedo[mat_id], table.albedo_tex, mat_id, uv)


def emission_at(table: MaterialTable, mat_id, uv=None):
    return _channel(table, table.emission[mat_id], table.emission_tex, mat_id, uv)


class BsdfSample(NamedTuple):
    direction: torch.Tensor  # (..., 3) outgoing direction, tangent space
    pdf: torch.Tensor  # (...,)
    reflectance: torch.Tensor  # (..., 3) BSDF value (specular: pre-divided by |cos|)
    is_delta: torch.Tensor  # (...,) bool


def fresnel_dielectric(cos_in, cos_out, eta_in, eta_out):
    """Unpolarized dielectric Fresnel from both angles."""
    r_par = (eta_out * cos_in - eta_in * cos_out) / (eta_out * cos_in + eta_in * cos_out)
    r_perp = (eta_in * cos_in - eta_out * cos_out) / (eta_in * cos_in + eta_out * cos_out)
    return 0.5 * (r_par * r_par + r_perp * r_perp)


def _mirror_dir(w):
    """Reflect about the tangent-space normal (+Y)."""
    return torch.stack([-w[..., 0], w[..., 1], -w[..., 2]], dim=-1)


def sample_bsdf(
    table: MaterialTable,
    mat_id: torch.Tensor,
    win: torch.Tensor,
    xi: torch.Tensor,
    mode: int = RADIANCE,
    uv: Optional[torch.Tensor] = None,
) -> BsdfSample:
    """Sample an outgoing direction per ray; `win` (..., 3) the tangent-space
    incoming direction (pointing away from the surface), `xi` (..., 2)
    uniforms; `uv` enables textured albedo."""
    kind = table.kind[mat_id]
    albedo = albedo_at(table, mat_id, uv)
    ior = table.ior[mat_id]
    cos_in_sgn = win[..., 1]
    abs_cos_in = torch.clamp(torch.abs(cos_in_sgn), min=1e-8)
    one = torch.ones_like(cos_in_sgn)

    # lambertian (double-sided cosine): warping is z-up, tangent space y-up;
    # flip to the incoming side where win.y < 0
    d = warping.unit_hemisphere_cosine_from_unit_square(xi)
    flip = cos_in_sgn < 0.0
    y_lam = torch.where(flip, -d[..., 2], d[..., 2])
    d_lam = torch.stack([d[..., 0], y_lam, d[..., 1]], dim=-1)
    pdf_lam = torch.abs(d_lam[..., 1]) / _PI
    f_lam = albedo / _PI

    # perfect mirror
    d_mir = _mirror_dir(win)
    pdf_mir = torch.ones_like(pdf_lam)
    f_mir = albedo / abs_cos_in[..., None]

    # dielectric transmission
    entering = cos_in_sgn >= 0.0
    eta_in = torch.where(entering, one, ior)
    eta_out = torch.where(entering, ior, one)
    cos_in = torch.abs(cos_in_sgn)
    sign = torch.where(entering, one, -one)
    eta = eta_in / eta_out
    sin2_out = (1.0 - cos_in * cos_in) * eta * eta
    tir = sin2_out >= 1.0
    cos_out = torch.where(tir, torch.zeros_like(sin2_out),
                          torch.sqrt(torch.where(tir, one, 1.0 - sin2_out)))
    fres = torch.where(tir, one, fresnel_dielectric(cos_in, cos_out, eta_in, eta_out))
    refract = (xi[..., 0] > fres) & ~tir
    d_refr = -eta[..., None] * win
    d_refr = torch.cat([d_refr[..., :1], d_refr[..., 1:2] + ((eta * cos_in - cos_out) * sign)[..., None],
                        d_refr[..., 2:]], dim=-1)
    d_tr = torch.where(refract[..., None], d_refr, _mirror_dir(win))
    pdf_tr = torch.where(refract, 1.0 - fres, fres)
    eta2 = eta * eta if mode == RADIANCE else one
    f_refr = (1.0 - fres)[..., None] * albedo / torch.clamp(cos_out, min=1e-8)[..., None]
    f_refr = f_refr * eta2[..., None]
    f_refl = fres[..., None] * albedo / cos_in[..., None]
    f_tr = torch.where(refract[..., None], f_refr, f_refl)
    pdf_tr = torch.where(tir, one, pdf_tr)
    f_tr = torch.where(tir[..., None], albedo / cos_in[..., None], f_tr)

    is_mir = kind == SPECULAR_REFLECTION
    is_tr = kind == SPECULAR_TRANSMISSION
    direction = torch.where(is_tr[..., None], d_tr, torch.where(is_mir[..., None], d_mir, d_lam))
    pdf = torch.where(is_tr, pdf_tr, torch.where(is_mir, pdf_mir, pdf_lam))
    refl = torch.where(is_tr[..., None], f_tr, torch.where(is_mir[..., None], f_mir, f_lam))
    return BsdfSample(direction=direction, pdf=pdf, reflectance=refl, is_delta=is_mir | is_tr)


def eval_bsdf(table: MaterialTable, mat_id, win, wout, uv=None):
    """f(in, out): nonzero only for the non-delta (Lambertian) kind."""
    kind = table.kind[mat_id]
    albedo = albedo_at(table, mat_id, uv)
    same_side = win[..., 1] * wout[..., 1] > 0.0
    f_lam = torch.where(same_side[..., None], albedo / _PI, torch.zeros_like(albedo))
    return torch.where((kind == LAMBERTIAN)[..., None], f_lam, torch.zeros_like(f_lam))


def pdf_bsdf(table: MaterialTable, mat_id, win, wout):
    """Solid-angle pdf of :func:`sample_bsdf` for the non-delta kind."""
    kind = table.kind[mat_id]
    same_side = win[..., 1] * wout[..., 1] > 0.0
    p_lam = torch.where(same_side, torch.abs(wout[..., 1]) / _PI, torch.zeros_like(wout[..., 1]))
    return torch.where(kind == LAMBERTIAN, p_lam, torch.zeros_like(p_lam))


def emission_of(table: MaterialTable, mat_id):
    return table.emission[mat_id]


def is_delta_kind(table: MaterialTable, mat_id):
    k = table.kind[mat_id]
    return (k == SPECULAR_REFLECTION) | (k == SPECULAR_TRANSMISSION)
