"""Run a function of this module on n gloo ranks of ``torch.distributed``, one
process each, for the port's multi-rank tests (``tests/test_torch_zshard.py``,
``tests/test_torch_sharding.py``).

:func:`run` writes the arguments to a directory, starts the n processes
(rendezvous through a ``FileStore`` there, every collective bounded by a
timeout), waits for them with a deadline of its own and kills them all if
it passes, so a deadlock fails the test instead of hanging the suite. Each
rank calls ``fn(mesh, **payload)`` on a CPU mesh and writes what it returns;
:func:`run` returns the ranks' results in rank order. The workers import
``torch`` and the port, never ``jax``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

_TESTS = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_TESTS)
_LAUNCH = "import sys; sys.path[:0] = sys.argv[1:3]; import torch_ranks; torch_ranks._main(*sys.argv[3:])"
COLLECTIVE_TIMEOUT = 60.0  # seconds


def run(n: int, fn: str, payload: dict, tmp_path, timeout: float = 120.0) -> list:
    """The results of ``fn(mesh, **payload)`` on n ranks, in rank order."""
    tmp = str(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    tag = f"{fn}-{n}-{time.monotonic_ns()}"
    torch.save(payload, os.path.join(tmp, f"{tag}.in"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _LAUNCH, _TESTS, _REPO, fn, str(r), str(n), tmp, tag],
            cwd=_REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for r in range(n)
    ]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            logs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise AssertionError(f"{fn} on {n} ranks did not finish in {timeout} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"{fn}: rank {r} exited with {p.returncode}:\n{log[-4000:]}")
    return [torch.load(os.path.join(tmp, f"{tag}.out{r}"), weights_only=False) for r in range(n)]


def _main(fn: str, rank: str, n: str, tmp: str, tag: str) -> None:
    import torch.distributed as dist

    from libfluid_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    rank, n = int(rank), int(n)
    store = dist.FileStore(os.path.join(tmp, f"{tag}.store"), n)
    distributed.init_distributed(backend="gloo", store=store, num_processes=n, process_id=rank,
                                 timeout=COLLECTIVE_TIMEOUT)
    mesh = distributed.global_mesh(("dp",), device="cpu")
    payload = torch.load(os.path.join(tmp, f"{tag}.in"), weights_only=False)
    out = globals()[fn](mesh, **payload)
    torch.save(out, os.path.join(tmp, f"{tag}.out{rank}"))
    dist.destroy_process_group()


class FixedDraws:
    """A substep's random numbers handed out in a fixed order: ("jitter",
    tensor) for ``source_jitter``, ("seed", int) for ``correction_seed``."""

    def __init__(self, items):
        self.items = list(items)

    def _next(self, kind):
        got, value = self.items.pop(0)
        assert got == kind, f"draw {kind} asked for, {got} next"
        return value

    def source_jitter(self, s, cfg):
        return self._next("jitter")

    def correction_seed(self):
        return self._next("seed")


def _state(arrays, cfg, sources):
    from libfluid_tpu_torch import convert

    st = convert.state_from_numpy(arrays, cfg, "cpu")
    if sources is not None:
        st = st._replace(sources=type(st.sources)(*(torch.as_tensor(a) for a in sources)))
    return st


def _diag(diag) -> dict:
    return {k: v.item() for k, v in diag._asdict().items()}


def _global(st, cfg, mesh) -> dict:
    from libfluid_tpu_torch import convert
    from libfluid_tpu_torch.parallel import zshard

    return convert.state_to_numpy(zshard.gather_state(st, cfg, mesh))


# ---------------------------------------------------------------------------
# Functions the ranks run
# ---------------------------------------------------------------------------


def substeps_z(mesh, cfg, arrays, dt, steps=1, draws=(), sources=None, capacity=None):
    """`steps` sharded substeps of the state `arrays`; the global state
    after each and its diagnostics, and the owner counts before and after."""
    from libfluid_tpu_torch.parallel import zshard

    st = zshard.zshard_state(_state(arrays, cfg, sources), cfg, mesh, per_device_capacity=capacity)
    draws = FixedDraws(draws) if draws else None
    before = int(st.active.sum())
    out = []
    for _ in range(steps):
        st, diag = zshard.substep_z(st, cfg, dt, mesh, draws)
        out.append((_global(st, cfg, mesh), _diag(diag)))
    return dict(steps=out, active_before=before, active_after=int(st.active.sum()))


def overflow_merges(substep, st, steps):
    """Run ``substep(st)`` `steps` times under ``profiling.tracing()``, each
    in a ``substep`` span; per substep, the count of ``p2g_overflow.plain``
    and the live rows of each plain P2G overflow merge's window."""
    from libfluid_tpu_torch import profiling
    from libfluid_tpu_torch.sim import transfers

    merge, rows = transfers._merge_overflow, []

    def counted(num, den, position, velocity, affine, active, idx, cfg):
        rows.append(int((idx < position.shape[0]).sum()))
        return merge(num, den, position, velocity, affine, active, idx, cfg)

    out = []
    transfers._merge_overflow = counted
    try:
        with profiling.tracing():
            for _ in range(steps):
                profiling.clear()
                rows.clear()
                with profiling.span("substep"):
                    st, diag = substep(st)
                (frame,) = profiling.frames()
                out.append(dict(count=frame.total("p2g_overflow.plain"), rows=list(rows),
                                overflow=int(diag.overflow_count)))
    finally:
        transfers._merge_overflow = merge
        profiling.clear()
    return out


def substeps_z_overflow(mesh, cfg, arrays, dt, steps=1):
    """:func:`overflow_merges` of `steps` sharded substeps of `arrays`."""
    from libfluid_tpu_torch.parallel import zshard

    st = zshard.zshard_state(_state(arrays, cfg, None), cfg, mesh)
    return overflow_merges(lambda s: zshard.substep_z(s, cfg, dt, mesh), st, steps)


def step_z(mesh, cfg, arrays, dt):
    from libfluid_tpu_torch.parallel import zshard

    st = zshard.zshard_state(_state(arrays, cfg, None), cfg, mesh)
    st, diag = zshard.step_z(st, cfg, dt, mesh)
    return _global(st, cfg, mesh), _diag(diag)


def halo_and_apply(mesh, x, ct, p, a_scale):
    """halo_exchange_z and pad_z of this rank's z-tile of `x`, and
    sharded_apply_A of its tile of `p` on the operator of `ct`."""
    from libfluid_tpu_torch.parallel import halo, zshard
    from libfluid_tpu_torch.parallel.mesh import grid_sharding_z
    from libfluid_tpu_torch.sim import pressure

    tile = grid_sharding_z(mesh).local
    op = pressure.build_operator(ct)
    cw = op.couple_w
    got = halo.sharded_apply_A(
        tile(op.fluid), tile(cw[:, :, :-1]), tile(cw[:, :, 1:]), tile(op.couple_u), tile(op.couple_v),
        tile(op.diag), tile(p), a_scale, mesh,
    )
    return dict(halo=halo.halo_exchange_z(tile(x), mesh), pad=zshard.pad_z(tile(x), mesh, fill=-1.0),
                apply=got, dot=halo.sharded_dot(tile(p), tile(p), mesh))


def shard_and_gather(mesh, cfg, arrays):
    """shard_sim_state's share, and the particle rows all ranks hold."""
    from libfluid_tpu_torch.parallel import halo, shard

    st = shard.shard_sim_state(_state(arrays, cfg, None), mesh)
    return dict(rows=halo.all_gather(st.position, mesh, dim=0), u=st.grid.u, w=st.grid.w)


def render_image(mesh, scene_name, cfg, seed):
    from libfluid_tpu_torch.parallel import shard

    scene, cam = _scene(scene_name)
    return shard.sharded_render(scene, cam, cfg, torch.Generator().manual_seed(seed), mesh)


def _scene(name):
    from libfluid_tpu_torch.renderer import scenes

    builder, cam = getattr(scenes, name)(1.0, device="cpu")
    return builder.finish(device="cpu"), cam


def ramp_texels() -> np.ndarray:
    """A smooth 8 x 8 ramp over uv: the emission of a proxy material whose
    radiance depends on where it is hit, so that a pixel gradient does not
    vanish (a glass or constant-albedo proxy under constant emitters gives
    none almost everywhere)."""
    u = np.linspace(0.0, 1.0, 8)
    return np.stack([0.2 + 0.8 * np.broadcast_to(u[None, :], (8, 8)),
                     0.2 + 0.8 * np.broadcast_to(u[:, None], (8, 8)), np.full((8, 8), 0.6)], -1)


def train(mesh, cfg, arrays, variants, nspheres, dt, seed):
    """One training step for each variant (rcfg, proxy material "glass" or
    "textured" (an emission ramp over uv), sphere radius) on the fluid-box scene with `nspheres`
    sphere proxies (``__graft_entry__.dryrun_multichip``'s scene), a black
    target; the substep's correction seed `seed`."""
    from libfluid_tpu_torch.parallel import shard
    from libfluid_tpu_torch.renderer import scenes

    out = []
    for rcfg, material, radius in variants:
        st = _state(arrays, cfg, None)
        builder, cam = scenes.fluid_box((0.0, 0.0, 0.0), tuple(float(n) for n in cfg.grid_size), aspect=1.0,
                                        device="cpu")
        if material == "glass":
            mat = builder.glass(1.33)
        else:
            mat = builder.lambertian((0.8, 0.8, 0.8), emission=(4.0, 4.0, 4.0),
                                     emission_tex=builder.add_texture(ramp_texels()))
        for _ in range(nspheres):
            builder.add_sphere(np.eye(3, 4), mat)
        scene = builder.finish(device="cpu")
        target = torch.zeros((rcfg.height, rcfg.width, 3))
        new, loss = shard.training_step(st, scene, cam, target, cfg, rcfg, mesh, dt, sphere_radius=radius,
                                        draws=FixedDraws([("seed", seed)]))
        out.append(dict(loss=float(loss), velocity=new.velocity))
    return out
