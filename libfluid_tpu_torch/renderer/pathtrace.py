"""Forward path tracer as a masked wavefront loop (port of
``libfluid_tpu.renderer.pathtrace``).

Up to ``max_bounces`` bounces; emission times throughput is accumulated at
every hit and the BSDF is sampled for the next ray; no next-event
estimation. Russian roulette from ``cfg.rr_start`` bounces on (survivors
reweighted by 1/p).

Three loops, each counting the rays it casts (``with_stats``):

- :func:`trace_rays`, a bounce loop over a batch of rays: with
  ``cfg.differentiable`` (the JAX package's ``scan``) every bounce runs;
  otherwise (its ``while_loop``) the loop stops once every lane is dead,
  reading that flag from the device once a bounce;
- :func:`trace_persistent` without an accelerator
  (:func:`_trace_persistent_brute`): persistent lanes that flush a finished
  path into the image and respawn the next pixel sample from a global
  counter, one brute-force cast and bounce an iteration;
- with an accelerator: on the card one launch of kernel ``pathtrace``
  (``csrc/pathtrace.cu``, :func:`_trace_persistent_kernel`), a thread a
  path; on the CPU its plain version :func:`_trace_persistent_mega`,
  traversal, shading and respawn in one loop, two grid-DDA steps an
  iteration. Counters ``pathtrace.kernel`` and ``pathtrace.plain`` say
  which ran.

The plain persistent tracers' loops are Python loops that read their exit
flag every ``loops.TRACE_CHECK_EVERY`` iterations (an iteration after the
last path is done changes nothing, so the result is that of testing every
iteration); the image scatter is ``index_add_``, whose float atomics on
the card make two runs differ in the last bits, as the kernel's do. Random
numbers come from a provider (:mod:`libfluid_tpu_torch.renderer.draws`) as
pure functions of (sample, bounce), so a path does not depend on the lane
or thread that traces it; the kernel computes :class:`HashDraws`' numbers
itself and takes no other provider.
"""

from __future__ import annotations

import torch

from libfluid_tpu_torch import profiling
from libfluid_tpu_torch.config import RenderConfig
from libfluid_tpu_torch.renderer import draws as draws_mod
from libfluid_tpu_torch.renderer import intersect, loops, materials
from libfluid_tpu_torch.renderer.scene import Scene
from libfluid_tpu_torch.sim import kernels

_RAY_OFFSET = 1e-3  # spawned-ray normal offset (float32 needs a larger skin than double)

# grid-DDA sub-steps per shading and respawn pass of the megakernel
_TRAV_STEPS_PER_SHADE = 2


def _shade(scene: Scene, cfg: RenderConfig, rec, d, xi):
    """The BSDF sample at a hit: (new origin, new direction, attenuation,
    pdf)."""
    frame = intersect.tangent_frame(rec.normal)  # world -> tangent
    win = torch.einsum("rij,rj->ri", frame, -d)
    samp = materials.sample_bsdf(scene.materials, rec.mat_id, win, xi, uv=rec.uv)
    atten = samp.reflectance * (torch.abs(samp.direction[..., 1])
                                / torch.clamp(samp.pdf, min=1e-12))[..., None]
    new_d = torch.einsum("rji,rj->ri", frame, samp.direction)  # tangent -> world
    sign = torch.where(samp.direction[..., 1] > 0.0, 1.0, -1.0).to(d.dtype)
    new_o = rec.position + rec.normal * (sign * _RAY_OFFSET)[:, None]
    return new_o, new_d, atten, samp.pdf


def _roulette(cfg: RenderConfig, tp, alive, u, rr_on):
    """Russian roulette: kill with probability 1 - p, reweight survivors by
    1/p; `rr_on` a bool or a per-lane mask."""
    p = torch.clamp(torch.amax(tp, dim=-1), cfg.rr_floor, 1.0)
    survive = u < p
    tp = torch.where((rr_on & alive & survive)[:, None], tp / p[:, None], tp)
    alive = alive & (survive | ~torch.as_tensor(rr_on, device=alive.device))
    return tp, alive


def _bounce(scene: Scene, cfg: RenderConfig, carry, xi, u, bounce_idx: int):
    o, d, radiance, throughput, alive, rays_cast = carry
    rec = intersect.ray_cast(scene, o, d)
    rays_cast = rays_cast + torch.sum(alive)
    live_hit = alive & rec.hit

    emis = materials.emission_at(scene.materials, rec.mat_id, rec.uv)
    radiance = radiance + torch.where(live_hit[:, None], throughput * emis, torch.zeros_like(emis))

    new_o, new_d, atten, pdf = _shade(scene, cfg, rec, d, xi)
    throughput = torch.where(live_hit[:, None], throughput * atten, throughput)
    alive = live_hit & (torch.amax(throughput, dim=-1) > 1e-7) & (pdf > 1e-12)
    throughput, alive = _roulette(cfg, throughput, alive, u, bounce_idx >= cfg.rr_start)

    o = torch.where(live_hit[:, None], new_o, o)
    d = torch.where(live_hit[:, None], new_d, d)
    return (o, d, radiance, throughput, alive, rays_cast)


def trace_rays(scene: Scene, origins: torch.Tensor, directions: torch.Tensor, rng, cfg: RenderConfig,
               with_stats: bool = False):
    """Incoming radiance (R, 3) for each ray; with `with_stats` also the
    number of rays cast (a device tensor). `rng` is a ``torch.Generator`` or
    a bounce stream (:mod:`~libfluid_tpu_torch.renderer.draws`)."""
    stream = draws_mod.as_stream(rng)
    r, dev = origins.shape[0], origins.device
    d = directions / torch.clamp(torch.linalg.norm(directions, dim=-1, keepdim=True), min=1e-30)
    carry = (
        origins,
        d,
        torch.zeros((r, 3), dtype=origins.dtype, device=dev),
        torch.ones((r, 3), dtype=origins.dtype, device=dev),
        torch.ones((r,), dtype=torch.bool, device=dev),
        torch.zeros((), dtype=torch.int64, device=dev),
    )
    for i in range(cfg.max_bounces):
        if not cfg.differentiable and not loops.flag(carry[4].any(), "pathtrace.bounce"):
            break
        xi, u = stream.bounce(i, r, dev)
        carry = _bounce(scene, cfg, carry, xi, u, i)
    if with_stats:
        return carry[2], carry[5]
    return carry[2]


@profiling.spanned("render")
def trace_persistent(scene: Scene, camera, cfg: RenderConfig, rng, with_stats: bool = False):
    """Persistent-threads wavefront path tracing: the estimator of
    :func:`trace_rays` times ``samples_per_pixel``, with lanes that never
    idle: a finished path is flushed into the image and its lane respawns
    the next pixel sample. With ``scene.accel`` set, the traversal is folded
    into the loop (the megakernel). Returns the (H, W, 3) radiance SUM over
    samples (divide by spp), and with `with_stats` the rays cast. `rng` is a
    ``torch.Generator`` or a draws provider; with the accelerator on the
    card only a :class:`~libfluid_tpu_torch.renderer.draws.HashDraws` (as a
    generator gives), since the kernel computes its numbers itself."""
    draws = draws_mod.as_draws(rng)
    if scene.accel is None:
        return _trace_persistent_brute(scene, camera, cfg, draws, with_stats)
    if kernels.use_kernel(scene.tri_p0, camera.position):
        if not isinstance(draws, draws_mod.HashDraws):
            raise TypeError(f"the persistent tracer on the card computes HashDraws' numbers itself; got "
                            f"{type(draws).__name__}")
        profiling.count("pathtrace.kernel")
        return _trace_persistent_kernel(scene, camera, cfg, draws, with_stats)
    profiling.count("pathtrace.plain")
    return _trace_persistent_mega(scene, camera, cfg, draws, with_stats)


class _Lanes:
    """What the two persistent tracers share: the lanes, the pixel grid and
    the respawn from the global sample counter."""

    def __init__(self, cfg: RenderConfig, camera, draws, device):
        w, h = cfg.width, cfg.height
        self.npix = w * h
        # the wavefront's width, independent of the image: lanes cycle
        # through the global sample stream
        self.lanes = min(self.npix, 1 << 16)
        self.total = self.npix * cfg.samples_per_pixel
        self.inv = torch.tensor([1.0 / w, 1.0 / h], dtype=torch.float32, device=device)
        gx, gy = torch.meshgrid(torch.arange(w, dtype=torch.float32, device=device),
                                torch.arange(h, dtype=torch.float32, device=device), indexing="xy")
        self.base_px = torch.stack([gx, gy], dim=-1).reshape(-1, 2)  # pixel corners, x fastest
        self.camera, self.draws, self.device = camera, draws, device
        self.minus1 = torch.full((self.lanes,), -1, dtype=torch.int64, device=device)

    def respawn(self, o, d, rad, tp, alive, pixel, sid, bounce, next_s):
        free = ~alive
        rank = torch.cumsum(free.long(), 0) - 1
        s_new = next_s + rank
        take = free & (s_new < self.total)
        pix = s_new % self.npix
        jit2 = self.draws.lane(s_new, self.minus1, 2)
        sp = (self.base_px[pix] + jit2) * self.inv
        o_new, d_new = self.camera.get_rays(sp)
        d_new = d_new / torch.clamp(torch.linalg.norm(d_new, dim=-1, keepdim=True), min=1e-30)
        t3 = take[:, None]
        return (
            torch.where(t3, o_new, o),
            torch.where(t3, d_new, d),
            torch.where(t3, torch.zeros_like(rad), rad),
            torch.where(t3, torch.ones_like(tp), tp),
            alive | take,
            torch.where(take, pix, pixel),
            torch.where(take, s_new, sid),
            torch.where(take, torch.zeros_like(bounce), bounce),
            next_s + torch.sum(take),
            take,
        )

    def start(self):
        z3 = torch.zeros((self.lanes, 3), dtype=torch.float32, device=self.device)
        zi = torch.zeros((self.lanes,), dtype=torch.int64, device=self.device)
        return self.respawn(z3, torch.ones_like(z3), z3, torch.ones_like(z3),
                            torch.zeros((self.lanes,), dtype=torch.bool, device=self.device),
                            zi, zi, zi, torch.zeros((), dtype=torch.int64, device=self.device))

    def running(self, alive, next_s) -> bool:
        """The exit test: a live lane, or samples left (one host read)."""
        return loops.flag(alive.any() | (next_s < self.total), "pathtrace.persistent")


def _shade_and_flush(scene, cfg, lanes: _Lanes, rec, ready, o, d, rad, tp, alive, pixel, sid, bounce,
                     img, next_s):
    """Shade the lanes in `ready` (their cast is complete), flush the paths
    that end into the image and respawn their lanes. Returns the new lane
    state, the lanes whose next ray needs a fresh traversal and the image."""
    live_hit = ready & rec.hit
    emis = materials.emission_at(scene.materials, rec.mat_id, rec.uv)
    rad = rad + torch.where(live_hit[:, None], tp * emis, torch.zeros_like(emis))

    u3 = lanes.draws.lane(sid, bounce, 3)
    new_o, new_d, atten, pdf = _shade(scene, cfg, rec, d, u3[:, :2])
    tp = torch.where(live_hit[:, None], tp * atten, tp)
    alive_n = live_hit & (torch.amax(tp, dim=-1) > 1e-7) & (pdf > 1e-12)
    tp, alive_n = _roulette(cfg, tp, alive_n, u3[:, 2], bounce >= cfg.rr_start)
    alive_n = alive_n & (bounce + 1 < cfg.max_bounces)

    o = torch.where(live_hit[:, None], new_o, o)
    d = torch.where(live_hit[:, None], new_d, d)
    bounce = torch.where(ready, bounce + 1, bounce)

    finished = ready & ~alive_n
    img.index_add_(0, pixel, torch.where(finished[:, None], rad, torch.zeros_like(rad)))
    alive2 = torch.where(ready, alive_n, alive)
    o, d, rad, tp, alive, pixel, sid, bounce, next_s, took = lanes.respawn(
        o, d, rad, tp, alive2, pixel, sid, bounce, next_s)
    need_init = (ready & alive_n) | took
    return (o, d, rad, tp, alive, pixel, sid, bounce, next_s), need_init


def _trace_persistent_brute(scene: Scene, camera, cfg: RenderConfig, draws, with_stats: bool = False):
    """Persistent tracer without an accelerator: each iteration one full
    brute-force cast and bounce of every lane."""
    lanes = _Lanes(cfg, camera, draws, scene.device)
    o, d, rad, tp, alive, pixel, sid, bounce, next_s, _ = lanes.start()
    img = torch.zeros((lanes.npix, 3), dtype=torch.float32, device=scene.device)
    cast = torch.zeros((), dtype=torch.int64, device=scene.device)
    it = 0
    while it % loops.TRACE_CHECK_EVERY or lanes.running(alive, next_s):
        it += 1
        rec = intersect.ray_cast(scene, o, d)
        cast = cast + torch.sum(alive)
        (o, d, rad, tp, alive, pixel, sid, bounce, next_s), _ = _shade_and_flush(
            scene, cfg, lanes, rec, alive, o, d, rad, tp, alive, pixel, sid, bounce, img, next_s)
    img = img.reshape(cfg.height, cfg.width, 3)
    if with_stats:
        return img, cast
    return img


def _trace_persistent_mega(scene: Scene, camera, cfg: RenderConfig, draws, with_stats: bool = False):
    """The persistent megakernel: every iteration advances each traversing
    lane by ``_TRAV_STEPS_PER_SHADE`` grid-DDA steps; lanes whose traversal
    just completed are shaded, bounced (or flushed and respawned) and their
    next ray's traversal initialized in the same iteration. Estimator, draws
    and cast accounting are those of the brute tracer."""
    from libfluid_tpu_torch.renderer import accel as accel_mod

    acc = scene.accel
    pack = accel_mod.pack_tris(scene)
    lanes = _Lanes(cfg, camera, draws, scene.device)
    o, d, rad, tp, alive, pixel, sid, bounce, next_s, _ = lanes.start()
    trav = accel_mod.init_state(acc, pack, o, d, 3.0e38)
    img = torch.zeros((lanes.npix, 3), dtype=torch.float32, device=scene.device)
    cast = torch.zeros((), dtype=torch.int64, device=scene.device)
    it = 0
    while it % loops.TRACE_CHECK_EVERY or lanes.running(alive, next_s):
        it += 1
        for _ in range(_TRAV_STEPS_PER_SHADE):
            trav = accel_mod.step_state(acc, pack, o, d, trav)
        ready = alive & ~trav.active  # this lane's cast just completed
        cast = cast + torch.sum(ready)
        rec = intersect.finalize_hit(scene, o, d, trav.best_t, trav.best_id, trav.best_u, trav.best_v,
                                     t_max=3.0e38)
        (o, d, rad, tp, alive, pixel, sid, bounce, next_s), need_init = _shade_and_flush(
            scene, cfg, lanes, rec, ready, o, d, rad, tp, alive, pixel, sid, bounce, img, next_s)
        ti = accel_mod.init_state(acc, pack, o, d, 3.0e38)
        trav = accel_mod.TravState(*(
            torch.where(need_init.reshape(need_init.shape + (1,) * (a.dim() - 1)), a, b)
            for a, b in zip(ti, trav)))
    img = img.reshape(cfg.height, cfg.width, 3)
    if with_stats:
        return img, cast
    return img


def _trace_persistent_kernel(scene: Scene, camera, cfg: RenderConfig, draws: draws_mod.HashDraws,
                             with_stats: bool = False):
    """:func:`_trace_persistent_mega`'s estimator as one launch of kernel
    ``pathtrace`` on CUDA tensors: a thread a path, every path of the frame
    (see ``csrc/pathtrace.cu``). Allocates the image and a two-word counter
    (samples claimed, rays cast) and reads nothing back."""
    from libfluid_tpu_torch.renderer import accel as accel_mod

    acc, mats = scene.accel, scene.materials
    textured = mats.textures is not None and mats.textures.shape[0] > 1
    pack = accel_mod.pack_tris(scene)
    f32, i64 = torch.float32, torch.int64
    n_tri, n_sph, n_mat = scene.tri_normal.shape[0], scene.sph_mat.shape[0], mats.kind.shape[0]
    # (tensor, dtype, shape): the kernel indexes the tables by the ids and
    # offsets the others hold, so their lengths must agree
    inputs = {
        "pack": (pack, f32, (n_tri + 1, 9)), "tri_normal": (scene.tri_normal, f32, (n_tri, 3)),
        "tri_mat": (scene.tri_mat, i64, (n_tri,)), "cell_start": (acc.cell_start, i64, (acc.num_cells + 1,)),
        "tri_ids": (acc.tri_ids, i64, acc.tri_ids.shape[:1]),
        "big_ids": (acc.big_ids, i64, acc.big_ids.shape[:1]),
        "dist": (acc.dist, i64, (acc.num_cells,)), "lo": (acc.lo, f32, (3,)), "cell": (acc.cell, f32, (3,)),
        "sph_to_local": (scene.sph_to_local, f32, (n_sph, 3, 4)), "sph_mat": (scene.sph_mat, i64, (n_sph,)),
        "kind": (mats.kind, i64, (n_mat,)), "albedo": (mats.albedo, f32, (n_mat, 3)),
        "ior": (mats.ior, f32, (n_mat,)), "emission": (mats.emission, f32, (n_mat, 3)),
        "camera position": (camera.position, f32, (3,)), "camera forward": (camera.norm_forward, f32, (3,)),
        "camera horizontal": (camera.half_horizontal, f32, (3,)),
        "camera vertical": (camera.half_vertical, f32, (3,)),
    }
    if textured:
        n_tex = mats.textures.shape[0]
        inputs.update({"albedo_tex": (mats.albedo_tex, i64, (n_mat,)),
                       "emission_tex": (mats.emission_tex, i64, (n_mat,)),
                       "textures": (mats.textures, f32, (n_tex, *mats.textures.shape[1:3], 3)),
                       "tex_hw": (mats.tex_hw, i64, (n_tex, 2))})
    kernels.use_kernel(*(t for t, _, _ in inputs.values()))
    for name, (t, dtype, shape) in inputs.items():
        kernels.check(t, dtype, shape, f"pathtrace {name}")
    tex = (mats.albedo_tex, mats.emission_tex, mats.textures, mats.tex_hw) if textured else (None,) * 4
    w, h = cfg.width, cfg.height
    img = torch.zeros((w * h, 3), dtype=torch.float32, device=scene.device)
    ctr = torch.zeros((2,), dtype=torch.int64, device=scene.device)
    rx, ry, rz = acc.res
    tex_h, tex_w = (mats.textures.shape[1], mats.textures.shape[2]) if textured else (0, 0)
    kernels.launch(
        "pathtrace", "lf_pathtrace", pack, scene.tri_normal, scene.tri_mat, acc.cell_start, acc.tri_ids,
        acc.big_ids, acc.dist, acc.lo, acc.cell, scene.sph_to_local, scene.sph_mat, mats.kind, mats.albedo,
        mats.ior, mats.emission, *tex, camera.position, camera.norm_forward,
        camera.half_horizontal, camera.half_vertical, img, ctr, acc.big_ids.shape[0], n_sph,
        rx, ry, rz, tex_h, tex_w, int(textured), w, h, cfg.samples_per_pixel, cfg.max_bounces, cfg.rr_start,
        float(cfg.rr_floor), 1.0 / w, 1.0 / h, draws.seed,
    )
    img = img.reshape(h, w, 3)
    if with_stats:
        return img, ctr[1]
    return img
