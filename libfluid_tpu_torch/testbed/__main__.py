"""Headless testbed CLI (port of ``libfluid_tpu.testbed.__main__``, on one
CUDA device).

The frame loop runs ``step(1/fps)`` per frame with the reference testbed's
per-step diagnostics, and exports OBJ meshes and point clouds. ``--scene``
renders a canned scene to a PPM with the forward path tracer. Rendering
the simulation (``--render-every``) and ``--algorithm bdpt`` are not ported
yet.

Examples:
    python -m libfluid_tpu_torch.testbed --setup 0 --frames 60
    python -m libfluid_tpu_torch.testbed --setup 4 --frames 2 --mesh-every 1 --out /tmp/tb
    python -m libfluid_tpu_torch.testbed --scene cornell1 --out /tmp/tb
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


def frame_loop(cfg, state, mesher_cfg, args) -> int:
    """Advance `state` by ``args.frames`` frames of 1/``args.fps`` on its own
    device, logging each frame's diagnostics and exporting an OBJ mesh every
    ``args.mesh_every`` frames and the particles every ``args.points_every``
    frames into ``args.out``. Returns 1 if the simulation diverged, else 0."""
    from libfluid_tpu_torch.io.obj import save_obj
    from libfluid_tpu_torch.io.point_cloud import save_points
    from libfluid_tpu_torch.mesher.marching_cubes import generate_mesh
    from libfluid_tpu_torch.sim import step

    device = state.position.device
    os.makedirs(args.out, exist_ok=True)
    frame_dt = 1.0 / args.fps
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

        if args.mesh_every and (frame + 1) % args.mesh_every == 0:
            t0 = time.time()
            mesh = generate_mesh(state.position, state.active, mesher_cfg, mesher_cfg.particle_radius)
            _sync(device)
            _log(f"    mesh: {int(mesh.count)} triangles ({(time.time() - t0) * 1e3:.0f} ms)")
            path = os.path.join(args.out, f"mesh_{frame:05d}.obj")
            save_obj(path, mesh.vertices.cpu().numpy(), int(mesh.count))
            _log(f"    wrote {path}")
        if args.points_every and (frame + 1) % args.points_every == 0:
            path = os.path.join(args.out, f"points_{frame:05d}.txt")
            save_points(path, state.position.cpu().numpy(), state.active.cpu().numpy())
            _log(f"    wrote {path}")

    total = time.time() - t_start
    _log(f"done: {args.frames} frames in {total:.2f} s ({args.frames / total:.2f} fps)")
    return 0


def run_sim(args) -> int:
    """Build testbed setup ``args.setup`` on the CUDA device and run the
    frame loop."""
    from libfluid_tpu_torch.testbed import SETUP_NAMES, build_setup, default_mesher_config

    if args.render_every:
        raise NotImplementedError(
            "--render-every needs fluid_render_scene, which is not ported yet (ROADMAP §1 item 2: "
            "BDPT, the fluid render scene and the pixel gradient)"
        )
    device = resolve_device(None)  # the card; raises where there is none
    cfg, state = build_setup(args.setup, seed=args.seed, device=device)
    _log(f"setup {args.setup}: {SETUP_NAMES[args.setup]}")
    _log(
        f"grid {cfg.grid_size} cell {cfg.cell_size} scheme {cfg.scheme.value} "
        f"capacity {cfg.particle_capacity}"
    )
    _log(f"device: {torch.cuda.get_device_name(device)}")
    return frame_loop(cfg, state, default_mesher_config(), args)


SCENE_BUILDERS = ("redgreen", "cornell1", "cornell2", "glass")


def run_scene(args, device=None) -> int:
    """Static render of a canned scene to ``<out>/<scene>.ppm`` (gamma 2.2)
    on `device` (None: the CUDA card; the tests pass ``"cpu"``)."""
    from libfluid_tpu_torch.config import RenderConfig
    from libfluid_tpu_torch.io.ppm import save_ppm
    from libfluid_tpu_torch.renderer import scenes as scenes_mod
    from libfluid_tpu_torch.renderer.render import BDPT_NOT_PORTED, render

    if args.algorithm == "bdpt":
        raise NotImplementedError(BDPT_NOT_PORTED)
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
    rcfg = RenderConfig(width=size, height=size, samples_per_pixel=spp, algorithm=args.algorithm)
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
    p.add_argument("--render-every", type=int, default=0, help="render every N frames (not ported yet)")
    p.add_argument("--render-size", type=int, default=400)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--algorithm", choices=["pt", "bdpt"], default="pt",
                   help="the path tracer; bdpt is not ported yet")
    p.add_argument("--offline-render", action="store_true",
                   help="with --scene: 800x800 @ 400 spp like the reference's F5")
    args = p.parse_args(argv)
    if args.scene:
        return run_scene(args, device)
    return run_sim(args)


if __name__ == "__main__":
    sys.exit(main())
