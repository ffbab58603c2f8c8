"""Headless testbed CLI (port of ``libfluid_tpu.testbed.__main__``, on one
CUDA device).

The frame loop runs ``step(1/fps)`` per frame with the reference testbed's
per-step diagnostics, and exports OBJ meshes, point clouds and rendered
frames (``--render-every``: the fluid scene of
:func:`~libfluid_tpu_torch.testbed.fluid_render_scene` to a PPM).
``--scene`` renders a canned scene to a PPM. ``--algorithm`` picks the
forward (``pt``) or the bidirectional (``bdpt``) path tracer.

Examples:
    python -m libfluid_tpu_torch.testbed --setup 0 --frames 60
    python -m libfluid_tpu_torch.testbed --setup 4 --frames 2 --mesh-every 1 --out /tmp/tb
    python -m libfluid_tpu_torch.testbed --setup 0 --frames 2 --render-every 1 --render-size 256 \
        --spp 4 --out /tmp/tb
    python -m libfluid_tpu_torch.testbed --scene cornell1 --algorithm bdpt --out /tmp/tb
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from libfluid_tpu_torch.config import resolve_device


def _log(*a):
    print(*a, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def frame_loop(cfg, state, mesher_cfg, args, device=None) -> int:
    """Advance `state` by ``args.frames`` frames of 1/``args.fps`` on
    `device` (None: the CUDA card; ``"cpu"`` on request), where the state
    must lie, logging each frame's diagnostics and exporting into
    ``args.out`` an OBJ mesh every ``args.mesh_every`` frames, the particles
    every ``args.points_every`` frames and a rendered frame every
    ``args.render_every`` frames (the fluid scene at ``args.render_size``^2 x
    ``args.spp`` with ``args.algorithm``). Returns 1 if the simulation
    diverged, else 0."""
    from libfluid_tpu_torch.config import RenderConfig
    from libfluid_tpu_torch.io.obj import save_obj
    from libfluid_tpu_torch.io.point_cloud import save_points
    from libfluid_tpu_torch.io.ppm import save_ppm
    from libfluid_tpu_torch.mesher.marching_cubes import generate_mesh
    from libfluid_tpu_torch.renderer.render import render
    from libfluid_tpu_torch.sim import step
    from libfluid_tpu_torch.testbed import fluid_render_scene

    device = resolve_device(device)
    if state.position.device != device:
        raise ValueError(f"frame_loop on {device}: the state lies on {state.position.device}")

    os.makedirs(args.out, exist_ok=True)
    frame_dt = 1.0 / args.fps
    # strips no longer than the image (the draws do not depend on the strip)
    rcfg = RenderConfig(width=args.render_size, height=args.render_size, samples_per_pixel=args.spp,
                        algorithm=args.algorithm, ray_batch=min(1 << 15, args.render_size ** 2))
    render_gen = torch.Generator().manual_seed(args.seed + 1)
    t_start = time.time()
    for frame in range(args.frames):
        t0 = time.time()
        state, diag = step(state, cfg, frame_dt)
        _sync(device)
        wall = time.time() - t0
        _log(f"frame {frame}  ({wall * 1e3:.0f} ms, {int(diag.substeps)} substeps)")
        _log(f"    total energy: {float(diag.kinetic_energy + diag.potential_energy):.6g}")
        iters = int(diag.pressure_iterations)
        _log(f"    iterations = {iters}")
        if iters > 100:
            _log("*** WARNING: large number of iterations")
        _log(f"    residual = {float(diag.pressure_residual):.6g}")
        _log(f"    max pressure = {float(diag.max_pressure):.6g}")
        _log(f"    max particle velocity = {float(diag.max_velocity):.6g}")
        _log(f"    particles = {int(diag.particle_count)}")
        if not np.isfinite(float(diag.max_velocity)):
            _log("*** ERROR: simulation diverged (NaN velocity); aborting")
            return 1

        want_mesh = args.mesh_every and (frame + 1) % args.mesh_every == 0
        want_render = args.render_every and (frame + 1) % args.render_every == 0
        if want_mesh or want_render:
            t0 = time.time()
            mesh = generate_mesh(state.position, state.active, mesher_cfg, mesher_cfg.particle_radius)
            _sync(device)
            _log(f"    mesh: {int(mesh.count)} triangles ({(time.time() - t0) * 1e3:.0f} ms)")
            if want_mesh:
                path = os.path.join(args.out, f"mesh_{frame:05d}.obj")
                save_obj(path, mesh.vertices.cpu().numpy(), int(mesh.count))
                _log(f"    wrote {path}")
            if want_render:
                t0 = time.time()
                scene, cam = fluid_render_scene(mesh, cfg, args.setup, tri_capacity=args.tri_capacity,
                                                device=device)
                img = render(scene, cam, rcfg, render_gen, device=device)
                _sync(device)
                if not bool(torch.isfinite(img).all()):
                    _log("*** ERROR: the rendered frame holds non-finite values")
                    return 1
                path = os.path.join(args.out, f"frame_{frame:05d}.ppm")
                save_ppm(path, img, gamma=2.2)
                _log(f"    rendered {path} ({time.time() - t0:.2f} s, {rcfg.algorithm})")
        if args.points_every and (frame + 1) % args.points_every == 0:
            path = os.path.join(args.out, f"points_{frame:05d}.txt")
            save_points(path, state.position.cpu().numpy(), state.active.cpu().numpy())
            _log(f"    wrote {path}")

    total = time.time() - t_start
    _log(f"done: {args.frames} frames in {total:.2f} s ({args.frames / total:.2f} fps)")
    return 0


def run_sim(args, device=None) -> int:
    """Build testbed setup ``args.setup`` on `device` (None: the CUDA card;
    ``"cpu"`` on request) and run the frame loop."""
    from libfluid_tpu_torch.testbed import SETUP_NAMES, build_setup, default_mesher_config

    device = resolve_device(device)
    cfg, state = build_setup(args.setup, seed=args.seed, device=device)
    _log(f"setup {args.setup}: {SETUP_NAMES[args.setup]}")
    _log(
        f"grid {cfg.grid_size} cell {cfg.cell_size} scheme {cfg.scheme.value} "
        f"capacity {cfg.particle_capacity}"
    )
    _log(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else device}")
    return frame_loop(cfg, state, default_mesher_config(), args, device)


SCENE_BUILDERS = ("redgreen", "cornell1", "cornell2", "glass")


def run_scene(args, device=None) -> int:
    """Static render of a canned scene to ``<out>/<scene>.ppm`` (gamma 2.2)
    on `device` (None: the CUDA card; the tests pass ``"cpu"``)."""
    from libfluid_tpu_torch.config import RenderConfig
    from libfluid_tpu_torch.io.ppm import save_ppm
    from libfluid_tpu_torch.renderer import scenes as scenes_mod
    from libfluid_tpu_torch.renderer.render import render

    device = resolve_device(device)
    builders = {
        "redgreen": scenes_mod.red_green_box,
        "cornell1": scenes_mod.cornell_box_one_light,
        "cornell2": scenes_mod.cornell_box_two_lights,
        "glass": scenes_mod.glass_ball_box,
    }
    builder, cam = builders[args.scene](1.0, device=device)
    scene = builder.finish(device=device)
    size = 800 if args.offline_render else args.render_size
    spp = 400 if args.offline_render else args.spp
    rcfg = RenderConfig(width=size, height=size, samples_per_pixel=spp, algorithm=args.algorithm,
                        ray_batch=min(1 << 15, size * size))
    _log(f"rendering {args.scene}: {size}x{size} @ {spp} spp ({args.algorithm}) on {device}")
    t0 = time.time()
    img = render(scene, cam, rcfg, torch.Generator().manual_seed(args.seed), device=device)
    _sync(device)
    wall = time.time() - t0
    _log(f"render: {wall:.2f} s  ({size * size * spp / wall / 1e6:.2f} Mpaths/s)")
    if not bool(torch.isfinite(img).all()):
        _log("*** ERROR: the image holds non-finite values")
        return 1
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.scene}.ppm")
    save_ppm(path, img, gamma=2.2)
    _log(f"wrote {path}")
    return 0


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(prog="python -m libfluid_tpu_torch.testbed", description=__doc__)
    p.add_argument("--setup", type=int, default=0, help="sim scenario 0-4")
    p.add_argument("--scene", choices=SCENE_BUILDERS,
                   help="render a static scene instead of simulating")
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--fps", type=float, default=60.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="testbed_out")
    p.add_argument("--mesh-every", type=int, default=0, help="export OBJ every N frames")
    p.add_argument("--points-every", type=int, default=0, help="export points every N frames")
    p.add_argument("--render-every", type=int, default=0, help="render PPM every N frames")
    p.add_argument("--render-size", type=int, default=400)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--algorithm", choices=["pt", "bdpt"], default="pt")
    p.add_argument("--tri-capacity", type=int, default=1 << 17,
                   help="static triangle capacity for the fluid render scene")
    p.add_argument("--offline-render", action="store_true",
                   help="with --scene: 800x800 @ 400 spp like the reference's F5")
    args = p.parse_args(argv)
    if args.scene:
        return run_scene(args, device)
    return run_sim(args, device)


if __name__ == "__main__":
    sys.exit(main())
