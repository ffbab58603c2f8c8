"""Parity of the port's staged V-cycle with the JAX package.

The port cuts ``multigrid.v_cycle`` into four stages, each a fused CUDA kernel
with a plain PyTorch version beside it; on CPU tensors the cycle is composed of
the plain versions. Here numpy-seeded cell types and right-hand sides go
through both packages: each plain stage against the JAX lines it covers
(rtol 1e-6 / atol 1e-5), the composed cycle against JAX's (1e-5 max|b|), the
stage composition against the per-pass composition, and the MG-PCG solve
(iterations within 1, pressure within 1e-4 max|p|). The bfloat16 ("mg16")
cycle, composed of the same stages, is held to the per-pass cycle bit for
bit (its solve against JAX's: ``tests/test_torch_flip.py``). The JAX
functions take their jnp path on the CPU (grids below 2^18 cells)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu import grids
from libfluid_tpu.config import CellType, SimConfig
from libfluid_tpu.sim import multigrid, pressure
from libfluid_tpu_torch import convert
from libfluid_tpu_torch import grids as t_grids
from libfluid_tpu_torch.sim import kernels as t_kernels
from libfluid_tpu_torch.sim import multigrid as t_multigrid
from libfluid_tpu_torch.sim import pressure as t_pressure

torch.set_num_threads(1)

# even, odd, the testbed's 50 -> 25 -> 13 -> 7 tail, and a grid with two
# levels above the small ones, the second of them odd
SHAPES = {
    "even16": (16, 16, 16),
    "odd": (13, 10, 9),
    "cube25": (25, 25, 25),
    "two_fine": (40, 36, 34),
}


def _cell_types(shape, seed=0, pool_frac=0.7):
    """Solid floor, a solid pillar, random fluid in the lower two thirds,
    air above."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = shape
    ct = np.full(shape, CellType.AIR, np.int8)
    ct[:, 0, :] = CellType.SOLID
    ct[nx // 3: nx // 3 + 2, :, nz // 3: nz // 3 + 2] = CellType.SOLID
    fluid = rng.uniform(size=shape) < pool_frac
    fluid[:, 2 * ny // 3:, :] = False
    ct[fluid & (ct == CellType.AIR)] = CellType.FLUID
    return ct


def _levels(name):
    ct = _cell_types(SHAPES[name])
    return multigrid.build_levels(jnp.asarray(ct)), t_multigrid.build_levels(torch.from_numpy(ct))


def _rhs(rng, level):
    fluid = np.asarray(level.fluid)
    return (20.0 * rng.normal(size=fluid.shape) * fluid).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("name", list(SHAPES))
def test_stage_functions_match_jax(name):
    """Down leg = _smooth + residual + _restrict, up leg = _prolong + _smooth,
    the coarse sub-cycle = v_cycle(levels, b, l), on every level."""
    levels, tlevels = _levels(name)
    assert len(levels) == len(tlevels) > 1
    rng = np.random.default_rng(5)
    for l in range(len(levels) - 1):
        lv, lc, tlv, tlc = levels[l], levels[l + 1], tlevels[l], tlevels[l + 1]
        b = _rhs(rng, lv)
        jb, tb = jnp.asarray(b), torch.from_numpy(b)
        x = multigrid._smooth(lv, jnp.zeros_like(jb), jb, multigrid._PRE_SMOOTH)
        tx = t_multigrid._pre_torch(tlv, tb)
        _close(tx, x)
        # the later stages on the JAX package's x, so that each is held alone
        tx = torch.from_numpy(np.array(x))
        rc = multigrid._restrict(lc, multigrid.residual(lv, x, jb))
        assert rc.shape == t_multigrid._coarse_shape(b.shape)
        _close(t_multigrid._restrict_residual_torch(tlv, tlc, tx, tb), rc)
        ec = rng.normal(size=rc.shape).astype(np.float32) * np.asarray(lc.fluid)
        up = multigrid._smooth(lv, x + multigrid._prolong(jnp.asarray(ec), b.shape) * lv.fluid, jb,
                               multigrid._POST_SMOOTH)
        _close(t_multigrid._up_torch(tlv, tx, torch.from_numpy(ec), tb), up)
    for l in range(len(levels)):
        b = _rhs(rng, levels[l])
        want = np.asarray(multigrid.v_cycle(levels, jnp.asarray(b), l))
        got = t_multigrid._coarse_torch(tlevels, torch.from_numpy(b), l).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("name", list(SHAPES))
def test_vcycle_matches_jax(name):
    levels, tlevels = _levels(name)
    b = _rhs(np.random.default_rng(6), levels[0])
    want = np.asarray(multigrid.v_cycle(levels, jnp.asarray(b)))
    t_kernels.reset_launches()
    got = t_multigrid.v_cycle(tlevels, torch.from_numpy(b)).numpy()
    assert not any(t_kernels.LAUNCHES.values())  # CPU tensors take the plain stages
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.max(np.abs(b))))
    assert np.max(np.abs(got)) > 0


@pytest.mark.parametrize("coarse_cells", [0, 16 ** 3, 1 << 30])
@pytest.mark.parametrize("name", ["odd", "cube25", "two_fine"])
def test_stage_composition_equals_per_pass(name, coarse_cells, monkeypatch):
    """Wherever the cut between the large levels' stages and the small
    levels' sub-cycle falls, the staged cycle is the per-pass cycle."""
    _, tlevels = _levels(name)
    b = torch.from_numpy(_rhs(np.random.default_rng(7), tlevels[0]))
    want = t_multigrid.v_cycle_per_pass(tlevels, b)
    monkeypatch.setattr(t_multigrid, "_COARSE_CELLS", coarse_cells)
    first = t_multigrid.first_coarse_level(tlevels)
    sizes = [lv.fluid.numel() for lv in tlevels]
    assert first == next((l for l, n in enumerate(sizes) if n <= coarse_cells), len(sizes) - 1)
    got = t_multigrid.v_cycle(tlevels, b)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(b.abs().max()))
    # and through the public stage wrappers, which take their plain versions here
    xs, bs = [], [b]
    for l in range(first):
        xs.append(t_multigrid.pre_smooth(tlevels[l], bs[-1]))
        bs.append(t_multigrid.restrict_residual(tlevels[l], tlevels[l + 1], xs[-1], bs[-1]))
    e = t_multigrid.coarse_cycle(tlevels, bs.pop(), first)
    for l in reversed(range(first)):
        e = t_multigrid.prolong_smooth(tlevels[l], xs.pop(), e, bs.pop())
    assert torch.equal(e, got)


def test_coarse_kernel_refuses_a_large_last_level():
    """A thin slab stops coarsening at once; its one level is more than the
    one-block kernel takes. The check that guards that launch still says so,
    and the route sends such a level to its sweeps instead."""
    shape = (72, 64, 8)
    tlevels = t_multigrid.build_levels(torch.from_numpy(_cell_types(shape)))
    assert len(tlevels) == 1 and t_multigrid.first_coarse_level(tlevels) == 0
    with pytest.raises(ValueError, match="too large for one block"):
        t_multigrid._check_coarse(tlevels)
    assert t_multigrid.bottom_route([lv.fluid.numel() for lv in tlevels], 0) == "sweeps"
    _, small = _levels("cube25")
    t_multigrid._check_coarse(small[t_multigrid.first_coarse_level(small):])


@pytest.mark.parametrize("shape,levels,route", [
    ((128, 64, 8), 1, "sweeps"),  # 65,536 cells in one level
    ((72, 64, 8), 1, "sweeps"),
    ((40, 36, 8), 1, "block"),  # 11,520 cells: one block still takes them
    ((16, 16, 16), 2, "block"),
    ((25, 25, 25), 3, "block"),
])
def test_bottom_route(shape, levels, route):
    """Which hierarchies end in the one-block kernel and which in sweeps of
    their last level: decided from the levels' cell counts alone."""
    tlevels = t_multigrid.build_levels(torch.from_numpy(_cell_types(shape)))
    assert len(tlevels) == levels
    cells = [lv.fluid.numel() for lv in tlevels]
    assert t_multigrid.bottom_route(cells, t_multigrid.first_coarse_level(tlevels)) == route
    # a large level that is not the last never takes the sweeps
    assert t_multigrid.bottom_route([1 << 21, 1 << 18], 0) == "block"


@pytest.mark.parametrize("shape", [(40, 36, 8), (24, 16, 8), (72, 64, 8)])
def test_thin_grid_vcycle_matches_jax(shape, monkeypatch):
    """A grid with an axis of 8 cells has one level: the cycle is that
    level's sweeps from zero. The plain cycle against the JAX package's, and
    the sweeps' path (what a last level too large for one block takes on the
    card, here on CPU tensors through the stencil's plain version) against
    the plain cycle."""
    ct = _cell_types(shape)
    levels = multigrid.build_levels(jnp.asarray(ct))
    tlevels = t_multigrid.build_levels(torch.from_numpy(ct))
    assert len(levels) == len(tlevels) == 1
    b = _rhs(np.random.default_rng(12), levels[0])
    want = np.asarray(multigrid.v_cycle(levels, jnp.asarray(b)))
    tb = torch.from_numpy(b)
    got = t_multigrid.v_cycle(tlevels, tb)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * float(np.max(np.abs(b))))
    assert np.max(np.abs(want)) > 0
    monkeypatch.setattr(t_multigrid, "_COARSE_CELLS_MAX", 1000)
    assert t_multigrid.bottom_route([tb.numel()], 0) == "sweeps"
    assert torch.equal(t_multigrid._launch_coarse(tlevels, tb, 0), got)


def test_vcycle_from_a_lower_level():
    """v_cycle(levels, b, l) starts at level l, as the JAX package's does."""
    levels, tlevels = _levels("two_fine")
    b = _rhs(np.random.default_rng(8), levels[1])
    want = np.asarray(multigrid.v_cycle(levels, jnp.asarray(b), 1))
    got = t_multigrid.v_cycle(tlevels, torch.from_numpy(b), 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.max(np.abs(b))))


def _bf16(tlevels):
    """The bfloat16 copy of a hierarchy, as ``pressure._cg``'s mg16 branch
    makes it."""
    return t_multigrid.Hierarchy(
        t_multigrid.MGLevel(*(a.to(torch.bfloat16) for a in lv[:6]), lv.scale) for lv in tlevels)


# the mg16 cycle's cases: three hierarchies of the float32 tests, and the
# thin grid of F1 (one level of 36,864 cells, too large for one block)
MG16_SHAPES = {name: SHAPES[name] for name in ("cube25", "two_fine", "odd")}
MG16_SHAPES["thin"] = (72, 64, 8)


@pytest.mark.parametrize("name", list(MG16_SHAPES))
def test_mg16_cycle_takes_the_per_pass_path(name, monkeypatch):
    """The bfloat16 cycle that v_cycle composes from the plain stages (the
    functions the fused "mg16_*" kernels are held to) is the per-pass
    cycle, bit for bit: every operation rounds to bfloat16 at the same
    point, with the same bfloat16 damping weight. On the thin grid the
    bottom's sweeps route (its "stencil16" passes on the card) is too."""
    tlevels = t_multigrid.build_levels(torch.from_numpy(_cell_types(MG16_SHAPES[name])))
    l16 = _bf16(tlevels)
    b = torch.from_numpy(_rhs(np.random.default_rng(9), tlevels[0])).to(torch.bfloat16)
    t_kernels.reset_launches()
    got = t_multigrid.v_cycle(l16, b)
    assert not any(t_kernels.LAUNCHES.values())
    assert got.dtype == torch.bfloat16 and float(got.float().abs().max()) > 0
    assert torch.equal(got, t_multigrid.v_cycle_per_pass(l16, b))
    if name == "thin":
        assert len(l16) == 1
        monkeypatch.setattr(t_multigrid, "_COARSE_CELLS_MAX", 1000)
        assert t_multigrid.bottom_route([b.numel()], 0) == "sweeps"
        assert torch.equal(t_multigrid._launch_coarse(l16, b, 0), got)


def test_mg16_plain_stages_take_the_bfloat16_damp():
    """The plain stages smooth with the damping weight rounded to bfloat16
    (0.80078125), as ``stencil`` (and the JAX package's weakly typed
    scalar) takes it. On a level whose inverse diagonal is not one of the
    few values a hierarchy holds, the unrounded 0.8 gives other bits."""
    assert t_multigrid._weak(t_multigrid._SMOOTH_DAMP, torch.bfloat16) == 0.80078125
    assert t_multigrid._weak(t_multigrid._SMOOTH_DAMP, torch.float32) == t_multigrid._SMOOTH_DAMP
    rng = np.random.default_rng(11)
    lv = t_multigrid.build_levels(torch.from_numpy(_cell_types((12, 10, 9))))[0]
    inv = torch.from_numpy(rng.uniform(0.1, 1.0, size=lv.fluid.shape).astype(np.float32))
    b = torch.from_numpy(_rhs(rng, lv)).to(torch.bfloat16)
    lv = _bf16([lv._replace(inv_diag=inv * lv.fluid)])[0]
    want = t_multigrid._smooth(lv, torch.zeros_like(b), b, t_multigrid._PRE_SMOOTH)
    assert torch.equal(t_multigrid._pre_torch(lv, b), want)
    x = torch.zeros_like(b)
    for _ in range(t_multigrid._PRE_SMOOTH):
        x = t_multigrid._stencil_torch(lv, x, b, t_multigrid.MODE_JACOBI, t_multigrid._SMOOTH_DAMP)
    assert not torch.equal(x * lv.fluid, want)


def test_mg16_cycle_on_the_card_launches_its_kernels_or_raises(monkeypatch):
    """On CUDA tensors a bfloat16 cycle runs the four "mg16_*" kernels (the
    bfloat16 damping weight their argument), a thin grid's bottom its
    "stencil16" sweeps, and nothing else; a launch that fails raises and a
    hierarchy the kernels do not take is refused: no per-pass fallback.
    Without a card the dispatch is made to see CUDA tensors and the
    launches are recorded."""
    launched, failing = [], []

    def launch(kernel, entry, *args):
        launched.append((kernel, args))
        if kernel in failing:
            raise RuntimeError(f"{kernel} kernel ({entry}) failed")

    monkeypatch.setattr(t_kernels, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(t_kernels, "launch", launch)
    # 40 x 36 x 34 down to 5 x 5 x 5
    tlevels = t_multigrid.build_levels(torch.from_numpy(_cell_types(SHAPES["two_fine"])))
    l16 = _bf16(tlevels)
    b = torch.zeros(SHAPES["two_fine"], dtype=torch.bfloat16)
    t_multigrid.v_cycle(l16, b)
    assert [k for k, _ in launched] == ["mg16_pre", "mg16_restrict"] * 2 + ["mg16_coarse"] + ["mg16_up"] * 2
    assert launched[0][1][-2] == 0.80078125
    launched.clear()
    thin = _bf16(t_multigrid.build_levels(torch.from_numpy(_cell_types((72, 64, 8)))))
    t_multigrid.v_cycle(thin, torch.zeros((72, 64, 8), dtype=torch.bfloat16))
    assert [k for k, _ in launched] == ["stencil16"] * t_multigrid._COARSE_ITERS
    failing.append("mg16_restrict")
    with pytest.raises(RuntimeError, match="mg16_restrict"):
        t_multigrid.v_cycle(l16, b)
    f16 = t_multigrid.Hierarchy(lv._replace(**{k: getattr(lv, k).half() for k in lv._fields[:6]})
                                for lv in tlevels)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        t_multigrid.v_cycle(f16, b.half())
    with pytest.raises(TypeError):
        t_multigrid.v_cycle((l16[0], *tlevels[1:]), b)


@pytest.mark.parametrize("name", ["cube25", "two_fine"])
def test_solve_with_staged_cycle_matches_jax(name):
    shape = SHAPES[name]
    rng = np.random.default_rng(10)
    nx, ny, nz = shape
    cfg = SimConfig(grid_size=shape, cell_size=1.0, particle_capacity=8)
    ct = _cell_types(shape)
    u = rng.normal(size=(nx + 1, ny, nz)).astype(np.float32)
    v = rng.normal(size=(nx, ny + 1, nz)).astype(np.float32)
    w = rng.normal(size=(nx, ny, nz + 1)).astype(np.float32)
    grid = grids.zeros(cfg)._replace(
        u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w), cell_type=jnp.asarray(ct))
    tcfg = convert.config_from_fields(**vars(cfg))
    tgrid = t_grids.MacGrid(u=torch.from_numpy(u), v=torch.from_numpy(v), w=torch.from_numpy(w),
                            cell_type=torch.from_numpy(ct))
    want = pressure.solve(grid, cfg, 0.01)
    got = t_pressure.solve(tgrid, tcfg, 0.01)
    assert int(want.iterations) > 0
    assert abs(int(got.iterations) - int(want.iterations)) <= 1
    p = np.asarray(want.pressure)
    assert np.max(np.abs(got.pressure.numpy() - p)) <= 1e-4 * np.max(np.abs(p))
    assert float(got.residual) < cfg.solver.tolerance


def test_fused_wrappers_refuse_what_the_kernels_do_not_take():
    """The checks the fused kernels' wrappers make before a launch: a wrong
    dtype, shape, layout or hierarchy raises, and a tensor that is neither on
    the card nor on the CPU raises too; nothing falls back."""
    _, tlevels = _levels("cube25")
    t_multigrid._check_hierarchy(tlevels)
    assert tlevels.fused_checked
    lv = tlevels[0]
    with pytest.raises(TypeError):
        t_multigrid._check_level(lv._replace(diag=lv.diag.double()))
    with pytest.raises(ValueError):
        t_multigrid._check_level(lv._replace(couple_v=lv.couple_u))
    with pytest.raises(ValueError):
        t_multigrid._check_level(lv._replace(fluid=lv.fluid.transpose(0, 2)))
    with pytest.raises(ValueError, match="2x coarsening"):
        t_multigrid._check_hierarchy((tlevels[0], tlevels[2]))
    meta = tuple(t_multigrid.MGLevel(*(a.to("meta") for a in l[:6]), l.scale) for l in tlevels)
    with pytest.raises(RuntimeError):
        t_multigrid.v_cycle(meta, torch.empty(SHAPES["cube25"], device="meta"))
