"""Headless testbed (port of ``libfluid_tpu.testbed``).

- :func:`build_setup`: the reference testbed's five scenarios, seeded from
  ``np.random.default_rng(seed)`` exactly as the JAX package seeds them.
- :func:`default_mesher_config`: the mesher thread's parameters.
- :func:`fluid_render_scene`: the fluid box around the domain with the
  water mesh as glass of IOR 1.7 (and setup 4's obstacle sphere).
- the CLI in ``__main__``: the frame loop with per-frame diagnostics and
  OBJ/points/PPM export.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from libfluid_tpu_torch.config import MesherConfig, SimConfig, TransferScheme, resolve_device
from libfluid_tpu_torch.math import transforms
from libfluid_tpu_torch.renderer import scenes as scenes_mod
from libfluid_tpu_torch.renderer.camera import Camera
from libfluid_tpu_torch.renderer.scene import Scene
from libfluid_tpu_torch.sim import SimState, new_state, seed_box, seed_sphere
from libfluid_tpu_torch.sim.sources import make_source_set
from libfluid_tpu_torch.sim.state import set_solid

SETUP_NAMES = {
    0: "dam-break box (20^3 in 50^3)",
    1: "sphere drop",
    2: "sphere + pool",
    3: "water wall",
    4: "jet source + spherical obstacle",
}

# particle capacity per setup (seed count + headroom)
_CAPACITY = {0: 1 << 17, 1: 1 << 17, 2: 1 << 19, 3: 1 << 18, 4: 1 << 17}


def default_config(setup: int, capacity: Optional[int] = None, **overrides) -> SimConfig:
    """The reference testbed's simulation parameters: 50^3 grid, cell 1.0,
    APIC, blending 1.0, gravity (0, -981, 0)."""
    kw = dict(
        grid_size=(50, 50, 50),
        cell_size=1.0,
        grid_offset=(0.0, 0.0, 0.0),
        gravity=(0.0, -981.0, 0.0),
        scheme=TransferScheme.APIC,
        blending_factor=1.0,
        particle_capacity=capacity or _CAPACITY[setup],
    )
    kw.update(overrides)
    return SimConfig(**kw)


def build_setup(
    setup: int, cfg: Optional[SimConfig] = None, seed: int = 0, device=None
) -> Tuple[SimConfig, SimState]:
    """Initial state on `device` (None: the CUDA card; ``"cpu"`` on request)
    for testbed scenario 0-4; `seed` seeds the particle jitter and the
    state's generator."""
    device = resolve_device(device)
    if setup not in SETUP_NAMES:
        raise ValueError(f"unknown setup {setup}; choose from {sorted(SETUP_NAMES)}")
    cfg = cfg or default_config(setup)
    rng = np.random.default_rng(seed)
    state = new_state(cfg, device, seed)

    if setup == 0:
        state = seed_box(state, cfg, (15.0, 15.0, 15.0), (20.0, 20.0, 20.0), rng=rng)
    elif setup == 1:
        state = seed_sphere(state, cfg, (25.0, 25.0, 25.0), 15.0, rng=rng)
    elif setup == 2:
        state = seed_sphere(state, cfg, (25.0, 44.0, 25.0), 5.0, rng=rng)
        state = seed_box(state, cfg, (0.0, 0.0, 0.0), (50.0, 15.0, 50.0), rng=rng)
    elif setup == 3:
        state = seed_box(state, cfg, (0.0, 0.0, 0.0), (10.0, 50.0, 50.0), rng=rng)
    elif setup == 4:
        # jet: cells x in [1,5), y in [25,35), z in [20,30), v=(200,0,0), coercing
        xs, ys, zs = np.meshgrid(
            np.arange(1, 5), np.arange(25, 35), np.arange(20, 30), indexing="ij"
        )
        cells = np.stack([xs, ys, zs], axis=-1).reshape(-1, 3)
        src = make_source_set(
            cells, (200.0, 0.0, 0.0), coerce_velocity=True,
            target_density=cfg.seeding_density, device=device,
        )
        state = state._replace(sources=src)
        # spherical solid obstacle: cell centers within radius 10 of (25,25,25)
        ii = np.indices(cfg.grid_size).transpose(1, 2, 3, 0)
        centers = (ii + 0.5) * cfg.cell_size + np.asarray(cfg.grid_offset)
        solid = np.sum((centers - np.array([25.0, 25.0, 25.0])) ** 2, axis=-1) < 100.0
        state = set_solid(state, solid)
    return cfg, state


def default_mesher_config(max_triangles: int = 1 << 18) -> MesherConfig:
    """The mesher thread's parameters: extent 2.0, cell 0.5, offset
    (-1, -1, -1), 104^3 cells."""
    return MesherConfig(
        grid_size=(104, 104, 104),
        cell_size=0.5,
        grid_offset=(-1.0, -1.0, -1.0),
        particle_extent=2.0,
        particle_radius=0.5,
        max_triangles=max_triangles,
    )


def fluid_render_scene(mesh, cfg: SimConfig, setup: int, aspect: float = 1.0,
                       tri_capacity: Optional[int] = None, device=None) -> Tuple[Scene, Camera]:
    """The testbed's fluid scene on `device` (None: the CUDA card; ``"cpu"``
    on request): the Cornell-style room around the simulation domain (fovy
    30 deg), the mesh's ``count`` triangles copied to the host with their
    winding reversed as glass of IOR 1.7, setup 4's obstacle proxy (a
    lambertian sphere of radius 10 at (25, 25, 25)), and above 1,024
    triangles the uniform-grid accelerator at 64^3."""
    device = resolve_device(device)
    dmin = np.asarray(cfg.domain_min)
    dmax = np.asarray(cfg.domain_max)
    builder, cam = scenes_mod.fluid_box(dmin, dmax, fovy=30.0 * np.pi / 180.0, aspect=aspect, device=device)
    water = builder.glass(1.7)
    count = int(mesh.count)
    verts = mesh.vertices[:count].detach().cpu().numpy()[:, ::-1, :]  # reversed face directions
    if count:
        builder.add_triangle_soup(verts, water)
    if setup == 4:
        blue = builder.lambertian((0.2, 0.5, 0.8))
        builder.add_sphere(np.asarray(transforms.scale_rotate_translate(
            np.array([10.0, 10.0, 10.0]), np.zeros(3), np.array([25.0, 25.0, 25.0]))), blue)
    scene = builder.finish(tri_capacity=tri_capacity, device=device)
    if count > 1024:
        from libfluid_tpu_torch.renderer import accel as accel_mod

        scene = scene._replace(accel=accel_mod.build(scene, res=(64, 64, 64), device=device))
    return scene, cam
