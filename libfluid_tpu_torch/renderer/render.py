"""Render loops over the pixel grid (port of
``libfluid_tpu.renderer.render``).

The whole image is one flat ray batch. With ``cfg.differentiable`` (the
default) every sample adds one jittered ray per pixel, traced in strips of
``cfg.ray_batch`` rays by the fixed-count bounce loop; otherwise the
persistent tracers run (``pathtrace.trace_persistent``). Random numbers
come from a provider (:mod:`libfluid_tpu_torch.renderer.draws`), keyed by a
``torch.Generator`` by default.
"""

from __future__ import annotations

import dataclasses

import torch

from libfluid_tpu_torch.config import RenderConfig, resolve_device
from libfluid_tpu_torch.renderer import draws as draws_mod
from libfluid_tpu_torch.renderer.camera import Camera
from libfluid_tpu_torch.renderer.pathtrace import trace_persistent, trace_rays
from libfluid_tpu_torch.renderer.scene import Scene

BDPT_NOT_PORTED = ("the bidirectional path tracer is not ported yet "
                   "(ROADMAP §1 item 2: BDPT, the fluid render scene and the pixel gradient)")


def render(scene: Scene, camera: Camera, cfg: RenderConfig, rng, device=None) -> torch.Tensor:
    """Render an (H, W, 3) radiance image with ``cfg.samples_per_pixel``
    jittered samples a pixel, on `device` (None: the CUDA card; ``"cpu"`` on
    request), where the scene and the camera must lie. `rng` is a
    ``torch.Generator`` or a draws provider."""
    device = resolve_device(device)
    if scene.device != device or camera.device != device:
        raise ValueError(f"render on {device}: the scene lies on {scene.device}, the camera on "
                         f"{camera.device}")
    if cfg.algorithm == "bdpt":
        raise NotImplementedError(BDPT_NOT_PORTED)
    draws = draws_mod.as_draws(rng)
    if not cfg.differentiable:
        # persistent lanes: a finished path's lane respawns the next sample
        return trace_persistent(scene, camera, cfg, draws) / cfg.samples_per_pixel

    w, h = cfg.width, cfg.height
    gx, gy = torch.meshgrid(torch.arange(w, dtype=torch.float32, device=device),
                            torch.arange(h, dtype=torch.float32, device=device), indexing="xy")
    base = torch.stack([gx, gy], dim=-1).reshape(-1, 2)  # (h*w, 2)
    inv = torch.tensor([1.0 / w, 1.0 / h], dtype=torch.float32, device=device)

    # strips of ray_batch rays; the last one padded, as in the JAX package
    # (its draws have the strip's shape)
    npix = w * h
    strip = cfg.ray_batch
    nstrips = -(-npix // strip)
    pad = nstrips * strip - npix
    base_p = torch.cat([base, torch.zeros((pad, 2), dtype=torch.float32, device=device)])

    acc = torch.zeros((npix, 3), dtype=torch.float32, device=device)
    for sample in range(cfg.samples_per_pixel):
        sp = (base_p + draws.jitter(sample, base_p.shape[0], device)) * inv
        parts = []
        for s in range(nstrips):
            o, d = camera.get_rays(sp[s * strip:(s + 1) * strip])
            parts.append(trace_rays(scene, o, d, draws.stream(sample, s, nstrips), cfg))
        acc = acc + torch.cat(parts)[:npix]
    img = acc / cfg.samples_per_pixel
    return img.reshape(h, w, 3)


def accumulate(scene: Scene, camera: Camera, cfg: RenderConfig, rng, acc, n, device=None):
    """Progressive accumulation: adds one sample per pixel into `acc`; the
    estimate is acc / n."""
    one = dataclasses.replace(cfg, samples_per_pixel=1)
    return acc + render(scene, camera, one, rng, device), n + 1


def render_image(scene: Scene, camera: Camera, cfg: RenderConfig, rng, device=None) -> torch.Tensor:
    """The render as a float image in [0, inf) (the JAX package jits
    :func:`render` here; the port runs it as it is)."""
    return render(scene, camera, cfg, rng, device)
