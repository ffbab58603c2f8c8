"""Pinhole camera (port of ``libfluid_tpu.renderer.camera``).

``from_parameters`` builds the forward and half-extent vectors scaled by
tan(fovy / 2); ``get_rays`` maps screen positions in [0, 1]^2 through
screen * 2 - 1. Ray directions are unnormalized (the tracers normalize).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from libfluid_tpu_torch.config import resolve_device


class Camera(NamedTuple):
    position: torch.Tensor  # (3,)
    norm_forward: torch.Tensor  # (3,)
    half_horizontal: torch.Tensor  # (3,)
    half_vertical: torch.Tensor  # (3,)

    @staticmethod
    def from_parameters(position, ref, up, fovy_radians, aspect_ratio, device=None) -> "Camera":
        """The camera at `position` looking at `ref`, on `device` (None: the
        CUDA card; ``"cpu"`` on request). Computed in float32 on the host,
        as the JAX package computes it."""
        device = resolve_device(device)
        position = torch.as_tensor(position, dtype=torch.float32)
        ref = torch.as_tensor(ref, dtype=torch.float32)
        up = torch.as_tensor(up, dtype=torch.float32)
        fwd = ref - position
        fwd = fwd / torch.linalg.norm(fwd)
        tan_half = torch.tan(torch.tensor(0.5 * fovy_radians, dtype=torch.float32))
        hh = torch.linalg.cross(fwd, up)
        nrm = torch.linalg.norm(hh)
        # degenerate up || forward: an arbitrary perpendicular
        if float(nrm) > 1e-12:
            hh = hh / torch.clamp(nrm, min=1e-30)
        else:
            hh = torch.linalg.cross(fwd, torch.tensor([1.0, 0.0, 0.0]))
        hv = torch.linalg.cross(fwd, hh)
        return Camera(
            position=position.to(device),
            norm_forward=fwd.to(device),
            half_horizontal=(hh * tan_half * float(aspect_ratio)).to(device),
            half_vertical=(hv * tan_half).to(device),
        )

    def get_rays(self, screen_pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """screen_pos (..., 2) in [0, 1]^2 -> (origins, directions)."""
        sp = screen_pos * 2.0 - 1.0
        d = (
            self.norm_forward
            + sp[..., 0:1] * self.half_horizontal
            + sp[..., 1:2] * self.half_vertical
        )
        o = torch.broadcast_to(self.position, d.shape)
        return o, d

    @property
    def device(self) -> torch.device:
        return self.position.device
