"""Gradients of the PyTorch port's stages against ``jax.vjp`` / ``jax.grad``
of the JAX package on the same numpy-seeded inputs: slot expand (through
``sort_and_build``), P2G (``_p2g_data``), the pressure solve (plus the
finite-difference check of ``test_pressure.py``), G2P, the correction
springs, the straight-through collision march and ``sample_surface`` +
``marching_cubes``. The port runs its plain versions here (CPU tensors),
whose autograd is what its CUDA backward kernels are held to on the card.

Tolerances: float32 sums taken in another order, relative to the largest
gradient entry (1e-5, or 1e-3 through an iterative solve whose own
tolerance bounds the agreement); finite differences as in the JAX
package's own tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu.config import MesherConfig, SimConfig, TransferScheme
from libfluid_tpu.mesher.marching_cubes import marching_cubes
from libfluid_tpu.mesher import surface
from libfluid_tpu.sim import collisions, correction, jitterhash, multigrid, pressure
from libfluid_tpu.sim import slotsort, transfers
from libfluid_tpu.sim.state import new_state, set_solid
from libfluid_tpu_torch import convert
from libfluid_tpu_torch import grids as t_grids
from libfluid_tpu_torch.config import MesherConfig as TMesherConfig
from libfluid_tpu_torch.mesher.marching_cubes import marching_cubes as t_marching_cubes
from libfluid_tpu_torch.mesher import surface as t_surface
from libfluid_tpu_torch.sim import collisions as t_collisions
from libfluid_tpu_torch.sim import correction as t_correction
from libfluid_tpu_torch.sim import kernels as t_kernels
from libfluid_tpu_torch.sim import multigrid as t_multigrid
from libfluid_tpu_torch.sim import pressure as t_pressure
from libfluid_tpu_torch.sim import slotsort as t_slotsort
from libfluid_tpu_torch.sim import transfers as t_transfers
from libfluid_tpu_torch.sim.state import set_solid as t_set_solid

from test_torch_pressure import _scene
from test_torch_substep import _state_arrays
from test_torch_transfers import G2P_CASES, _g2p_model, g2p_case

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_rel(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.max(np.abs(want)))
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _particles(scheme, n_grid=8, seed=0, n=600, on_faces=24):
    """A random particle state on an n_grid^3 grid; `on_faces` particles
    sit exactly on faces and cell centres, where the hats have their kinks
    (the subgradient conventions of the two frameworks meet there)."""
    cfg = SimConfig(grid_size=(n_grid,) * 3, particle_capacity=1 << 10, scheme=scheme,
                    max_neighbors_per_cell=4)
    rng = np.random.default_rng(seed)
    cap = cfg.particle_capacity
    pos = rng.uniform(0.6, n_grid - 0.6, (cap, 3)).astype(np.float32)
    pos[:on_faces] = rng.integers(1, n_grid - 1, (on_faces, 3)) + rng.choice(
        [0.0, 0.5], (on_faces, 3))
    active = np.zeros(cap, bool)
    active[:n] = True
    vel = rng.standard_normal((cap, 3)).astype(np.float32)
    aff = (rng.standard_normal((cap, 3, 3)) * 0.3).astype(np.float32)
    state = new_state(cfg, jax.random.PRNGKey(seed))._replace(
        position=jnp.asarray(pos), velocity=jnp.asarray(vel), affine=jnp.asarray(aff),
        active=jnp.asarray(active),
    )
    tcfg = convert.config_from_fields(**vars(cfg))
    return cfg, tcfg, state


def _port_state(state, tcfg):
    return convert.state_from_numpy(_state_arrays(state), tcfg, "cpu")


@pytest.mark.parametrize("scheme", [TransferScheme.APIC, TransferScheme.PIC])
def test_expand_grad_matches_jax(scheme):
    """d sum(W * sin(slot payload)) / d (position, velocity, affine) through
    the sort and the slot expand (kernel A; invalid slots drop their
    cotangent), both packages."""
    cfg, tcfg, state = _particles(scheme)
    k = cfg.max_neighbors_per_cell
    weights = np.random.default_rng(1).standard_normal((16, k) + cfg.grid_size).astype(np.float32)

    def f(pos, vel, aff):
        st = state._replace(position=pos, velocity=vel, affine=aff)
        data = slotsort.sort_and_build(st, cfg).slot_grid.data
        return jnp.sum(jnp.asarray(weights) * jnp.sin(data))

    want = jax.grad(f, argnums=(0, 1, 2))(state.position, state.velocity, state.affine)
    tstate = _port_state(state, tcfg)
    leaves = [tstate.position.clone().requires_grad_(), tstate.velocity.clone().requires_grad_(),
              tstate.affine.clone().requires_grad_()]
    st = tstate._replace(position=leaves[0], velocity=leaves[1], affine=leaves[2])
    data = t_slotsort.sort_and_build(st, tcfg).slot_grid.data
    got = torch.autograd.grad(torch.sum(_t(weights) * torch.sin(data)), leaves, allow_unused=True)
    for g, w, leaf in zip(got, want, leaves):
        g = torch.zeros_like(leaf) if g is None else g  # PIC's payload holds no affine
        if float(jnp.max(jnp.abs(w))) == 0.0:
            assert float(g.abs().max()) == 0.0
        else:
            _assert_rel(g.numpy(), w, 1e-6)


@pytest.mark.parametrize("scheme", [TransferScheme.APIC, TransferScheme.PIC])
def test_p2g_grad_matches_jax(scheme):
    """The payload cotangent of the six unnormalized face arrays: the port's
    P2G Function (plain autograd on the CPU; kernel B' on the card) against
    ``_p2g_data``'s custom VJP."""
    cfg, tcfg, state = _particles(scheme, seed=2)
    data = slotsort.sort_and_build(state, cfg).slot_grid.data
    rng = np.random.default_rng(3)
    nx, ny, nz = cfg.grid_size
    shapes = [(nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)]
    cot = [rng.standard_normal(s).astype(np.float32) for s in shapes + shapes]
    _, vjp = jax.vjp(lambda d: transfers._p2g_data(d, cfg), data)
    (want,) = vjp((tuple(jnp.asarray(c) for c in cot[:3]), tuple(jnp.asarray(c) for c in cot[3:])))

    leaf = _t(data).requires_grad_()
    num, den = t_kernels.p2g_faces(leaf, tcfg)
    (got,) = torch.autograd.grad((*num, *den), leaf, [_t(c) for c in cot])
    _assert_rel(got.numpy(), want, 1e-5)
    assert float(jnp.max(jnp.abs(want[0:3]))) > 0  # the position rows are exercised


@pytest.mark.parametrize("precond", ["mg", "jacobi", "mg16"])
def test_pressure_solve_grad_matches_jax(precond):
    """b_bar of sum(p^2 + q p) through the implicit-adjoint solve; the warm
    start gets no gradient."""
    cfg, grid, tcfg, tgrid = _scene((8, 8, 8), 0.5, 4, 0.5, False)
    a_scale = 0.015 / (cfg.density * cfg.cell_size**2)
    levels = multigrid.build_levels(grid.cell_type)
    b0 = pressure.compute_rhs(grid, cfg)
    q = np.random.default_rng(6).standard_normal(b0.shape).astype(np.float32)
    x0 = np.random.default_rng(7).standard_normal(b0.shape).astype(np.float32)
    tol, iters = cfg.solver.tolerance, cfg.solver.max_iterations

    def scalar(b):
        p = pressure.solve_pressure_system(levels, b, a_scale, jnp.asarray(x0), tol, iters,
                                           precond).pressure
        return jnp.sum(p**2 + jnp.asarray(q) * p)

    want = jax.grad(scalar)(b0)
    tlevels = t_multigrid.build_levels(tgrid.cell_type)
    b = _t(b0).requires_grad_()
    tx0 = _t(x0).requires_grad_()
    p = t_pressure.solve_pressure_system(tlevels, b, a_scale, tx0, tol, iters, precond).pressure
    got, g_x0 = torch.autograd.grad(torch.sum(p**2 + _t(q) * p), (b, tx0), allow_unused=True)
    assert g_x0 is None
    _assert_rel(got.numpy(), want, 1e-3)


def test_pressure_grad_matches_finite_differences():
    """The port's version of test_pressure.test_pressure_vjp_is_adjoint_solve."""
    _, grid, tcfg, tgrid = _scene((8, 8, 8), 0.5, 4, 0.5, False)
    a_scale = 0.015 / (tcfg.density * tcfg.cell_size**2)
    levels = t_multigrid.build_levels(tgrid.cell_type)
    op = t_pressure.build_operator(tgrid.cell_type)
    b0 = t_pressure.compute_rhs(tgrid, tcfg)

    def scalar(b):
        res = t_pressure.solve_pressure_system(
            levels, b, a_scale, torch.zeros_like(b), tcfg.solver.tolerance,
            tcfg.solver.max_iterations, tcfg.solver.preconditioner,
        )
        return torch.sum(res.pressure**2)

    b = b0.clone().requires_grad_()
    (g,) = torch.autograd.grad(scalar(b), b)
    probe = torch.from_numpy(np.random.default_rng(5).normal(size=b0.shape).astype(np.float32)) * op.fluid
    eps = 1e-2
    fd = (scalar(b0 + eps * probe) - scalar(b0 - eps * probe)) / (2 * eps)
    np.testing.assert_allclose(float(torch.sum(g * probe)), float(fd), rtol=3e-2)


def _random_grid(cfg, seed):
    rng = np.random.default_rng(seed)
    nx, ny, nz = cfg.grid_size
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))]


def test_g2p_grad_matches_jax():
    """Cotangents of (u, v, w, position) from random velocity and affine
    cotangents, particles on faces and cell centres included."""
    cfg, tcfg, state = _particles(TransferScheme.APIC, seed=4)
    uvw = _random_grid(cfg, 5)
    pos = np.asarray(state.position)[np.asarray(state.active)]
    rng = np.random.default_rng(6)
    gv = rng.standard_normal((pos.shape[0], 3)).astype(np.float32)
    ga = rng.standard_normal((pos.shape[0], 3, 3)).astype(np.float32)

    def f(u, v, w, p):
        grid = state.grid._replace(u=u, v=v, w=w)
        return transfers.g2p_pic(grid, p, cfg)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in uvw), jnp.asarray(pos))
    want = vjp((jnp.asarray(gv), jnp.asarray(ga)))
    leaves = [_t(a).requires_grad_() for a in uvw + [pos]]
    grid = t_grids.MacGrid(*leaves[:3], None)
    got = torch.autograd.grad(t_transfers.g2p_pic(grid, leaves[3], tcfg), leaves, (_t(gv), _t(ga)))
    for g, w in zip(got, want):
        _assert_rel(g.numpy(), w, 1e-5)


@pytest.mark.parametrize("case", G2P_CASES)
def test_g2p_bwd_kernel_model_matches_jax(case):
    """Kernel D''s arithmetic (kernel D's tables with the subgradient factor,
    windows of three where a distance lies on an end of the support, the
    face cotangents summed in a block's box and written back at its end, or
    straight into the face arrays where the box does not fit) against
    ``jax.vjp`` of the
    JAX package's g2p_pic, and the port's plain autograd against the same."""
    cfg, uvw, pos = g2p_case(case)
    rng = np.random.default_rng(18)
    gv = rng.standard_normal((pos.shape[0], 3)).astype(np.float32)
    ga = rng.standard_normal((pos.shape[0], 3, 3)).astype(np.float32)
    grid = new_state(cfg, jax.random.PRNGKey(0)).grid

    def f(u, v, w, p):
        return transfers.g2p_pic(grid._replace(u=u, v=v, w=w), p, cfg)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in uvw), jnp.asarray(pos))
    want = vjp((jnp.asarray(gv), jnp.asarray(ga)))
    _, got, counts = _g2p_model(uvw, pos, cfg, gv, ga)
    for g, w in zip(got, want):
        _assert_rel(g, w, 1e-5)
    assert counts["triples"] > 0 if case.endswith("kinks") else counts["triples"] == 0
    # in cell order most particles go through a box; shuffled, a block's
    # range rarely fits and most add straight into the face arrays
    n = pos.shape[0]
    assert 0 < counts["boxed"] < n
    assert counts["boxed"] > n // 2 if case.startswith("sorted") else counts["boxed"] < n // 2
    tcfg = convert.config_from_fields(**vars(cfg))
    leaves = [_t(a).requires_grad_() for a in uvw + [pos]]
    tgrid = t_grids.MacGrid(*leaves[:3], None)
    plain = torch.autograd.grad(t_transfers.g2p_pic(tgrid, leaves[3], tcfg), leaves, (_t(gv), _t(ga)))
    for g, w in zip(plain, want):
        _assert_rel(g.numpy(), w, 1e-5)


def test_g2p_affine_grad_matches_finite_differences():
    """The position gradient of G2P's affine rows holds a second-order term
    (the hat's derivative in the other two axes); central differences in
    float64 on particles away from faces see it."""
    _, tcfg, _ = _particles(TransferScheme.APIC)
    rng = np.random.default_rng(8)
    uvw = [torch.from_numpy(a.astype(np.float64)) for a in _random_grid(tcfg, 9)]
    pos = torch.from_numpy(rng.uniform(1.6, 6.4, (16, 3)))
    pos = torch.floor(pos) + 0.1 + 0.3 * torch.frac(pos)  # off the faces and centres
    wv = torch.from_numpy(rng.standard_normal((16, 3)))
    wa = torch.from_numpy(rng.standard_normal((16, 3, 3)))
    grid = t_grids.MacGrid(*uvw, None)

    def loss(p):
        vel, aff = t_transfers.g2p_pic(grid, p, tcfg)
        return torch.sum(vel * wv) + torch.sum(aff * wa)

    p = pos.clone().requires_grad_()
    (g,) = torch.autograd.grad(loss(p), p)
    eps = 1e-6
    fd = torch.zeros_like(pos)
    for i in range(pos.shape[0]):
        for q in range(3):
            e = torch.zeros_like(pos)
            e[i, q] = eps
            fd[i, q] = (loss(pos + e) - loss(pos - e)) / (2 * eps)
    np.testing.assert_allclose(g.numpy(), fd.numpy(), rtol=1e-6, atol=1e-6)


def test_springs_grad_matches_jax():
    """The correction springs' VJP (kernel E's plain version, recomputed in
    backward) with exactly coincident slots, where the jitter acts."""
    cfg, tcfg, state = _particles(TransferScheme.APIC, seed=10, on_faces=0)
    pos = np.array(state.position)
    pos[600:640] = pos[:40]  # coincident pairs
    act = np.array(state.active)
    act[600:640] = True
    state = state._replace(position=jnp.asarray(pos), active=jnp.asarray(act))
    sg = slotsort.sort_and_build(state, cfg).slot_grid
    kc = cfg.max_neighbors_per_cell
    res_pos, res_mask = sg.position[:, :kc], sg.mask[:kc]
    re2 = cfg.cell_size**2 / 2.0
    seed = int(jitterhash.seed_from_key(jax.random.PRNGKey(11)))
    g = np.random.default_rng(12).standard_normal(res_pos.shape).astype(np.float32)
    _, vjp = jax.vjp(
        lambda p, m: correction._springs(p, m, jnp.int32(seed), jnp.zeros((3,), jnp.int32), re2, cfg),
        res_pos, res_mask,
    )
    want = vjp(jnp.asarray(g))
    leaves = [_t(res_pos).requires_grad_(), _t(res_mask).requires_grad_()]
    out = t_correction._springs(*leaves, seed, (0, 0, 0), re2, tcfg)
    got = torch.autograd.grad(out, leaves, _t(g))
    for a, b in zip(got, want):
        _assert_rel(a.numpy(), b, 1e-5)


def test_collision_march_is_straight_through_as_in_jax():
    """Obstacles on: the march passes the cotangent to the new position and
    none to the old; the skin push-out after it differentiates as plain
    arithmetic. Both packages, the same particles."""
    cfg, tcfg, state = _particles(TransferScheme.APIC, seed=13, on_faces=0)
    solid = np.zeros(cfg.grid_size, bool)
    solid[3:5, 2:6, 2:6] = True
    state = set_solid(state, solid)
    rng = np.random.default_rng(14)
    old = np.asarray(state.position)
    new = np.clip(old + rng.normal(0.0, 1.5, old.shape), 0.2, 7.8).astype(np.float32)
    wts = rng.standard_normal(old.shape).astype(np.float32)

    def f(o, n):
        return jnp.sum(collisions.resolve_collisions(o, n, state.solid, cfg) * jnp.asarray(wts))

    want = jax.grad(f, argnums=(0, 1))(jnp.asarray(old), jnp.asarray(new))
    tsolid = t_set_solid(_port_state(state, tcfg), solid).solid
    leaves = [_t(old).requires_grad_(), _t(new).requires_grad_()]
    out = t_collisions.resolve_collisions(*leaves, tsolid, tcfg)
    got = torch.autograd.grad(torch.sum(out * _t(wts)), leaves, allow_unused=True)
    assert got[0] is None and float(jnp.max(jnp.abs(want[0]))) == 0.0
    # a coordinate on a skin push-out's switch (cell_pos == skin or
    # h - skin, where the push-out itself puts it) takes either branch on
    # the two packages' one-ulp forward differences; those are left out
    cp = np.asarray(out.detach()) % cfg.cell_size
    skin = cfg.boundary_skin_width
    keep = (np.abs(cp - skin) > 1e-5) & (np.abs(cp - (cfg.cell_size - skin)) > 1e-5)
    assert keep.mean() > 0.9
    _assert_rel(got[1].numpy()[keep], np.asarray(want[1])[keep], 1e-6)


def test_surface_and_marching_cubes_grad_matches_jax():
    """d (mesh vertices . W) / d positions through sample_surface and
    marching_cubes (differentiable in the SDF through the edge crossings),
    both packages, the same triangles."""
    kw = dict(grid_size=(20, 20, 20), cell_size=0.5, grid_offset=(-1.0, -1.0, -1.0),
              particle_extent=1.2, particle_radius=0.35, max_triangles=1 << 13)
    rng = np.random.default_rng(15)
    pos = rng.normal(4.0, 1.2, (900, 3)).astype(np.float32)
    active = np.ones(pos.shape[0], bool)
    active[::7] = False
    cfg = MesherConfig(**kw)
    tcfg = TMesherConfig(**kw)
    wts = rng.standard_normal((cfg.max_triangles, 3, 3)).astype(np.float32)

    def f(p):
        mesh = marching_cubes(surface.sample_surface(p, jnp.asarray(active), cfg), cfg)
        mask = (jnp.arange(cfg.max_triangles) < mesh.count).astype(p.dtype)
        return jnp.sum(mesh.vertices * jnp.asarray(wts) * mask[:, None, None])

    want = jax.grad(f)(jnp.asarray(pos))
    p = _t(pos).requires_grad_()
    mesh = t_marching_cubes(t_surface.sample_surface(p, _t(active), tcfg), tcfg)
    mask = (torch.arange(tcfg.max_triangles) < mesh.count).to(p.dtype)
    (got,) = torch.autograd.grad(torch.sum(mesh.vertices * _t(wts) * mask[:, None, None]), p)
    assert int(mesh.count) > 100
    _assert_rel(got.numpy(), want, 1e-4)


def test_marching_cubes_grad_matches_finite_differences():
    """The port's version of test_mesher.test_mc_vertices_differentiable_wrt_sdf:
    the per-block host reads leave the vertices differentiable in the SDF."""
    cfg = TMesherConfig(grid_size=(8, 8, 8), cell_size=1.0, max_triangles=1024)
    axes = [np.arange(9, dtype=np.float32)] * 3
    g = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    sdf0 = torch.from_numpy((np.linalg.norm(g - 4.0, axis=-1) - 2.0).astype(np.float32))

    def loss(sdf):
        mesh = t_marching_cubes(sdf, cfg)
        return torch.sum(mesh.vertices[:, :, 1] * mesh.valid.to(sdf.dtype)[:, None])

    s = sdf0.clone().requires_grad_()
    (gn,) = torch.autograd.grad(loss(s), s)
    assert bool(torch.isfinite(gn).all()) and float(gn.abs().max()) > 0
    cand = gn.abs() * (sdf0.abs() > 0.3)
    idx = np.unravel_index(int(cand.argmax()), gn.shape)
    eps = 1e-3
    e = torch.zeros_like(sdf0)
    e[idx] = eps
    fd = (loss(sdf0 + e) - loss(sdf0 - e)) / (2 * eps)
    np.testing.assert_allclose(float(gn[idx]), float(fd), rtol=5e-2)
