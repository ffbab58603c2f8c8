"""Sample warping from the unit square (port of
``libfluid_tpu.math.warping``): `xi` is (..., 2) uniform in [0, 1)^2;
pdfs are in solid-angle measure."""

from __future__ import annotations

import math

import torch

_PI = math.pi


def unit_disk_from_unit_square(xi: torch.Tensor) -> torch.Tensor:
    """Polar warp square -> disk."""
    r = torch.sqrt(xi[..., 0])
    theta = 2.0 * _PI * xi[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def unit_disk_from_unit_square_concentric(xi: torch.Tensor) -> torch.Tensor:
    """Shirley-Chiu concentric disk warp."""
    offset = 2.0 * xi - 1.0
    ox, oy = offset[..., 0], offset[..., 1]
    degenerate = (ox == 0.0) & (oy == 0.0)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    safe = torch.where(degenerate, torch.ones_like(ox), torch.where(use_x, ox, oy))
    theta = torch.where(
        use_x,
        (_PI / 4.0) * (oy / safe),
        (_PI / 2.0) - (_PI / 4.0) * (ox / safe),
    )
    pt = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return torch.where(degenerate[..., None], torch.zeros_like(pt), pt)


def unit_sphere_from_unit_square(xi: torch.Tensor) -> torch.Tensor:
    """Uniform sphere."""
    z = 1.0 - 2.0 * xi[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * _PI * xi[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def pdf_unit_sphere() -> float:
    return 1.0 / (4.0 * _PI)


def unit_hemisphere_from_unit_square(xi: torch.Tensor) -> torch.Tensor:
    """Uniform hemisphere around +z."""
    z = xi[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * _PI * xi[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def pdf_unit_hemisphere() -> float:
    return 1.0 / (2.0 * _PI)


def unit_hemisphere_cosine_from_unit_square(xi: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere around +z through the concentric disk."""
    d = unit_disk_from_unit_square_concentric(xi)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, min=0.0))
    return torch.cat([d, z[..., None]], dim=-1)


def pdf_unit_hemisphere_cosine(direction: torch.Tensor) -> torch.Tensor:
    """cos(theta) / pi, +z the normal."""
    return torch.abs(direction[..., 2]) / _PI
