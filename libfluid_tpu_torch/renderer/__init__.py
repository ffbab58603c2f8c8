"""Renderer: wavefront path tracing on PyTorch tensors (port of
``libfluid_tpu.renderer``, forward only; the bidirectional tracer is not
ported yet).

Primitives and materials are flat tensors with integer kind ids; the
tracers are loops over masked ray batches; random numbers come from a
counter-based provider (:mod:`~libfluid_tpu_torch.renderer.draws`).
"""

from libfluid_tpu_torch.renderer.camera import Camera
from libfluid_tpu_torch.renderer.scene import Scene, SceneBuilder
from libfluid_tpu_torch.renderer import materials, scenes
from libfluid_tpu_torch.renderer.pathtrace import trace_rays
from libfluid_tpu_torch.renderer.render import render, render_image

__all__ = [
    "Camera",
    "Scene",
    "SceneBuilder",
    "materials",
    "scenes",
    "trace_rays",
    "render",
    "render_image",
]
