"""Canned test scenes (port of ``libfluid_tpu.renderer.scenes``): the
Cornell-style boxes, the glass-sphere scene, and the fluid box that wraps
the simulation domain. Each returns a :class:`SceneBuilder` (call
``finish(device=...)``) and a :class:`Camera` on `device` (None: the CUDA
card; ``"cpu"`` on request)."""

from __future__ import annotations

import numpy as np

from portbench.reference.lf.math import transforms
from portbench.reference.lf.renderer.camera import Camera
from portbench.reference.lf.renderer.scene import SceneBuilder, unit_box, unit_plane

_PI = np.pi

WHITE = (0.725, 0.71, 0.68)
RED = (0.63, 0.065, 0.05)
GREEN = (0.14, 0.45, 0.091)


def _srt(s, e, t) -> np.ndarray:
    """The (3, 4) transform in float32, as the JAX package computes it."""
    return transforms.scale_rotate_translate(
        np.asarray(s, np.float64), np.asarray(e, np.float64), np.asarray(t, np.float64)
    ).numpy().astype(np.float64)


def _red_green_builder(b: SceneBuilder):
    """The empty red/green room."""
    white = b.lambertian(WHITE)
    red = b.lambertian(RED)
    green = b.lambertian(GREEN)
    plane_p, plane_i = unit_plane()
    b.add_mesh(plane_p, plane_i, white, _srt((10, 1, 10), (_PI, 0, 0), (0, -2.5, 0)))  # floor
    b.add_mesh(plane_p, plane_i, red, _srt((10, 1, 10), (0, 0, -0.5 * _PI), (5, 2.5, 0)))  # left (+x)
    b.add_mesh(plane_p, plane_i, green, _srt((10, 1, 10), (0, 0, 0.5 * _PI), (-5, 2.5, 0)))  # right (-x)
    b.add_mesh(plane_p, plane_i, white, _srt((10, 1, 10), (0.5 * _PI, 0, 0), (0, 2.5, 5)))  # back
    b.add_mesh(plane_p, plane_i, white, _srt((10, 1, 10), (0, 0, 0), (0, 7.5, 0)))  # ceiling
    return white


def _default_camera(aspect, device):
    return Camera.from_parameters(
        (0.0, 5.5, -30.0), (0.0, 2.5, 0.0), (0.0, 1.0, 0.0),
        19.5 * _PI / 180.0, aspect, device=device,
    )


def red_green_box(aspect=1.0, device=None):
    b = SceneBuilder()
    _red_green_builder(b)
    return b, _default_camera(aspect, device)


def _add_cornell_cubes(b: SceneBuilder, white: int):
    """The two boxes."""
    box_p, box_i = unit_box()
    b.add_mesh(box_p, box_i, white, _srt((3, 6, 3), (0, 27.5 * _PI / 180, 0), (2, 0, 3)))
    b.add_mesh(box_p, box_i, white, _srt((3, 3, 3), (0, -17.5 * _PI / 180, 0), (-2, -1, 0.75)))


def cornell_box_one_light(aspect=1.0, device=None):
    """Cornell box with one bright warm area light."""
    b = SceneBuilder()
    white = _red_green_builder(b)
    _add_cornell_cubes(b, white)
    light = b.lambertian(WHITE, emission=(34.0, 24.0, 8.0))
    plane_p, plane_i = unit_plane()
    b.add_mesh(plane_p, plane_i, light, _srt((3, 1, 3), (0, 0, 0), (0, 7.45, 0)))
    return b, _default_camera(aspect, device)


def cornell_box_two_lights(aspect=1.0, device=None):
    """Cornell box with warm and cool lights."""
    b = SceneBuilder()
    white = _red_green_builder(b)
    _add_cornell_cubes(b, white)
    plane_p, plane_i = unit_plane()
    ly = b.lambertian(WHITE, emission=(17.0, 12.0, 4.0))
    lb = b.lambertian(WHITE, emission=(4.0, 12.0, 17.0))
    b.add_mesh(plane_p, plane_i, ly, _srt((3, 1, 3), (0, 0, 0), (2, 7.45, 0)))
    b.add_mesh(plane_p, plane_i, lb, _srt((3, 1, 3), (0, 0, 0), (-2, 7.45, 0)))
    return b, _default_camera(aspect, device)


def glass_ball_box(aspect=1.0, device=None):
    """Red/green room with a glass sphere, IOR 1.55."""
    b = SceneBuilder()
    _red_green_builder(b)
    glass = b.glass(1.55)
    b.add_sphere(_srt((3, 3, 3), (0, 27.5 * _PI / 180, 0), (0, 1.25, 0)), glass)
    light = b.lambertian(WHITE, emission=(34.0, 24.0, 8.0))
    plane_p, plane_i = unit_plane()
    b.add_mesh(plane_p, plane_i, light, _srt((3, 1, 3), (0, 0, 0), (0, 7.45, 0)))
    return b, _default_camera(aspect, device)


def fluid_box(dmin, dmax, fovy=50.0 * _PI / 180.0, aspect=1.0, tri_capacity=None, device=None):
    """Cornell-style room wrapping the simulation domain with two area
    lights and an auto-fitted camera. Returns the builder, so the fluid
    surface can still be added before ``finish()``."""
    dmin = np.asarray(dmin, np.float64)
    dmax = np.asarray(dmax, np.float64)
    center = 0.5 * (dmin + dmax)
    size = dmax - dmin

    b = SceneBuilder()
    white = b.lambertian(WHITE)
    red = b.lambertian(RED)
    green = b.lambertian(GREEN)
    plane_p, plane_i = unit_plane()
    b.add_mesh(plane_p, plane_i, white, _srt(size, (_PI, 0, 0), (center[0], dmin[1], center[2])))
    b.add_mesh(plane_p, plane_i, white, _srt(size, (-_PI, 0, 0), (center[0], dmax[1], center[2])))
    b.add_mesh(plane_p, plane_i, red, _srt(size, (0, 0, 0.5 * _PI), (dmin[0], center[1], center[2])))
    b.add_mesh(plane_p, plane_i, green, _srt(size, (0, 0, -0.5 * _PI), (dmax[0], center[1], center[2])))
    b.add_mesh(plane_p, plane_i, white, _srt(size, (0.5 * _PI, 0, 0), (center[0], center[1], dmax[2])))
    ly = b.lambertian(WHITE, emission=(17.0, 12.0, 4.0))
    lb = b.lambertian(WHITE, emission=(4.0, 12.0, 17.0))
    b.add_mesh(
        plane_p, plane_i, ly,
        _srt((0.3 * size[0], 1, 0.3 * size[2]), (0, 0, 0),
             (center[0] - 0.25 * size[0], dmax[1] - 0.05, center[2])),
    )
    b.add_mesh(
        plane_p, plane_i, lb,
        _srt((0.3 * size[0], 1, 0.3 * size[2]), (0, 0, 0),
             (center[0] + 0.25 * size[0], dmax[1] - 0.05, center[2])),
    )

    tan_half_y = np.tan(0.5 * fovy)
    tan_half_x = aspect * tan_half_y
    dist = max(0.5 * size[1] / tan_half_y, 0.5 * size[0] / tan_half_x)
    cam = Camera.from_parameters(
        (center[0], center[1], dmin[2] - dist - 10.0), tuple(center), (0, 1, 0),
        fovy, aspect, device=device,
    )
    return b, cam
