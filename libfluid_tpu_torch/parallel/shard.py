"""Sharded simulation and render steps and the end-to-end training step
(port of ``libfluid_tpu.parallel.shard``).

PyTorch has no GSPMD: a rank computes on what it holds, and the
communication is written out. So :func:`shard_sim_state` hands a rank its
share of the JAX package's layout (particle rows, z-tiles), the sharded
substep is :func:`~libfluid_tpu_torch.parallel.zshard.substep_z` on
:func:`~libfluid_tpu_torch.parallel.zshard.zshard_state`'s share, a render
splits the pixels over the ranks, and a training step backpropagates each
rank's share of the pixel loss and sums the gradient with ``all_reduce``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from libfluid_tpu_torch.config import RenderConfig, SimConfig
from libfluid_tpu_torch.parallel import halo
from libfluid_tpu_torch.parallel.mesh import Layout, RankMesh, grid_sharding_z, particle_sharding, replicated
from libfluid_tpu_torch.renderer import draws as draws_mod
from libfluid_tpu_torch.renderer.camera import Camera
from libfluid_tpu_torch.renderer.pathtrace import trace_rays
from libfluid_tpu_torch.renderer.scene import Scene
from libfluid_tpu_torch.sim.state import SimState
from libfluid_tpu_torch.sim.step import Draws, substep


def shard_sim_state(state: SimState, mesh: RankMesh, shard_grid: Optional[bool] = None) -> SimState:
    """This rank's share of the JAX package's layout: a block of the
    particle rows and, when the grid is tall enough, the z-tiles of the
    grid, solid and pressure arrays (w, whose nz+1 faces do not split, by
    y), the rest whole. A data placement only: the sharded substep
    redistributes the particles by z-slab (:func:`sharded_substep`)."""
    ndev = mesh.size
    ny, nz = state.grid.u.shape[1], state.grid.u.shape[2]
    if shard_grid is None:
        # z tiles thinner than ~4 cells spend more on halos than stencils
        shard_grid = ndev > 1 and nz >= 4 * ndev and ny >= ndev
    rows = particle_sharding(mesh)
    gsh = grid_sharding_z(mesh) if shard_grid else replicated(mesh)
    wsh = Layout(mesh, 1) if shard_grid else replicated(mesh)

    def put(layout: Layout, x: torch.Tensor) -> torch.Tensor:
        return layout.local(x).to(mesh.device).contiguous()

    g = state.grid
    return state._replace(
        position=put(rows, state.position), velocity=put(rows, state.velocity),
        affine=put(rows, state.affine), active=put(rows, state.active),
        grid=g._replace(u=put(gsh, g.u), v=put(gsh, g.v), w=put(wsh, g.w), cell_type=put(gsh, g.cell_type)),
        solid=put(gsh, state.solid), pressure=put(gsh, state.pressure),
        sources=type(state.sources)(*(t.to(mesh.device) for t in state.sources)),
        time=state.time.to(mesh.device),
    )


def sharded_substep(state: SimState, cfg: SimConfig, dt, mesh: RankMesh, draws: Optional[Draws] = None):
    """The explicitly sharded substep of a whole state (the same on every
    rank): ``zshard_state`` then ``substep_z``, as in the JAX package.
    Returns this rank's new share and the reduced diagnostics."""
    from libfluid_tpu_torch.parallel.zshard import substep_z, zshard_state

    return substep_z(zshard_state(state, cfg, mesh), cfg, dt, mesh, draws)


def _pixel_range(cfg: RenderConfig, mesh: RankMesh) -> Tuple[int, int]:
    npix = cfg.width * cfg.height
    if npix % mesh.size != 0:
        raise ValueError(f"{npix} pixels do not split over {mesh.size} ranks")
    share = npix // mesh.size
    return mesh.rank * share, (mesh.rank + 1) * share


def _render_share(scene: Scene, camera: Camera, cfg: RenderConfig, draws, mesh: RankMesh) -> torch.Tensor:
    """This rank's pixels (P, 3) of the image, row-major, ``P = H*W /
    ranks``: the fixed-count tracer, its draws keyed by the global pixel
    index (the jitter by pixel, the bounce stream as strip ``rank`` of
    ``ranks`` strips of P rays), so the image does not depend on the number
    of ranks. Differentiable with respect to the scene."""
    lo, hi = _pixel_range(cfg, mesh)
    dev = mesh.device
    w, h = cfg.width, cfg.height
    pix = torch.arange(lo, hi, device=dev)
    base = torch.stack([(pix % w).to(torch.float32), (pix // w).to(torch.float32)], dim=-1)
    inv = torch.tensor([1.0 / w, 1.0 / h], dtype=torch.float32, device=dev)
    acc = None
    for s in range(cfg.samples_per_pixel):
        sp = (base + draws.jitter(s, w * h, dev)[lo:hi]) * inv
        o, d = camera.get_rays(sp)
        rad = trace_rays(scene, o, d, draws.stream(s, mesh.rank, mesh.size), cfg)
        acc = rad if acc is None else acc + rad
    return acc / cfg.samples_per_pixel


def sharded_render(scene: Scene, camera: Camera, cfg: RenderConfig, rng, mesh: RankMesh) -> torch.Tensor:
    """An (H, W, 3) radiance image on every rank, its pixels split over the
    ranks and gathered (ref ``rendering.h``'s OpenMP rows). `rng` is a
    ``torch.Generator`` (the same state on every rank) or a draws provider.
    The JAX package keys each device's rays with ``fold_in(key, device)``,
    so its image depends on the device count; this one does not."""
    draws = draws_mod.as_draws(rng)
    with torch.no_grad():
        part = _render_share(scene, camera, cfg, draws, mesh)
    return halo.all_gather(part, mesh, dim=0).reshape(cfg.height, cfg.width, 3)


def _spheres_at(scene: Scene, centers: torch.Tensor, radius: float) -> Scene:
    """Differentiable scene update: the scene's S spheres at `centers`
    (S, 3) with one `radius` (the proxy geometry linking particles to
    pixels without the mesher)."""
    s = centers.shape[0]
    eye = torch.eye(3, dtype=centers.dtype, device=centers.device)
    to_world = torch.cat([(eye * radius).expand(s, 3, 3), centers[:, :, None]], dim=-1)
    to_local = torch.cat([(eye / radius).expand(s, 3, 3), -centers[:, :, None] / radius], dim=-1)
    return scene._replace(sph_to_world=to_world, sph_to_local=to_local)


def training_step(
    state: SimState, scene: Scene, camera: Camera, target_image: torch.Tensor, cfg: SimConfig,
    rcfg: RenderConfig, mesh: RankMesh, dt: float, lr: float = 1e-2, sphere_radius: float = 0.5,
    draws: Optional[Draws] = None,
) -> Tuple[SimState, torch.Tensor]:
    """One differentiable-physics step on the initial velocities: a dense
    substep (every rank runs it on the whole state, as the JAX package's
    replicated computation does), the first S active particles as the
    scene's S sphere proxies, the pixels rendered over the ranks. The loss
    is the mean squared error over all pixels; each rank backpropagates its
    pixels' share and an ``all_reduce`` sums the velocity gradient. Returns
    (the substep's state with the updated velocities, the loss). The
    render's draws are keyed by the state's generator after the substep
    (the JAX package renders with the key the substep leaves)."""
    nspheres = scene.sph_mat.shape[0]
    vel = state.velocity.detach().requires_grad_(True)
    st, _ = substep(state._replace(velocity=vel), cfg, dt, draws)
    sc = _spheres_at(scene, st.position[:nspheres], sphere_radius)
    lo, hi = _pixel_range(rcfg, mesh)
    part = _render_share(sc, camera, rcfg, draws_mod.HashDraws.from_generator(st.generator), mesh)
    target = target_image.reshape(-1, 3)[lo:hi].to(part.device)
    loss_share = torch.sum((part - target) ** 2) / (rcfg.width * rcfg.height * 3)
    (grad,) = torch.autograd.grad(loss_share, vel)
    grad = halo.all_sum(grad, mesh)
    loss = halo.all_sum(loss_share.detach(), mesh)
    st = st._replace(
        position=st.position.detach(), velocity=(vel - lr * grad).detach(), affine=st.affine.detach(),
        grid=type(st.grid)(*(t.detach() for t in st.grid)), pressure=st.pressure.detach(),
    )
    return st, loss
