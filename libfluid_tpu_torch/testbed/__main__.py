"""Headless testbed CLI (port of ``libfluid_tpu.testbed.__main__``, on one
CUDA device; rendering is not ported yet).

The frame loop runs ``step(1/fps)`` per frame with the reference testbed's
per-step diagnostics, and exports OBJ meshes and point clouds.

Examples:
    python -m libfluid_tpu_torch.testbed --setup 0 --frames 60
    python -m libfluid_tpu_torch.testbed --setup 4 --frames 2 --mesh-every 1 --out /tmp/tb
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
            "--render-every needs the renderer, which is not ported yet (ROADMAP: the renderer)"
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m libfluid_tpu_torch.testbed", description=__doc__)
    p.add_argument("--setup", type=int, default=0, help="sim scenario 0-4")
    p.add_argument("--scene", help="render a static scene (not ported yet)")
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--fps", type=float, default=60.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="testbed_out")
    p.add_argument("--mesh-every", type=int, default=0, help="export OBJ every N frames")
    p.add_argument("--points-every", type=int, default=0, help="export points every N frames")
    p.add_argument("--render-every", type=int, default=0, help="render every N frames (not ported yet)")
    args = p.parse_args(argv)
    if args.scene:
        raise NotImplementedError(
            "--scene needs the renderer, which is not ported yet (ROADMAP: the renderer)"
        )
    return run_sim(args)


if __name__ == "__main__":
    sys.exit(main())
