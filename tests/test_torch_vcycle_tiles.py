"""The tile algorithms of the fused V-cycle's "mg_up", "mg_coarse",
"mg16_pre" and "mg_restrict" / "mg16_restrict" kernels
(``libfluid_tpu_torch/csrc/vcycle.cu``), modelled in PyTorch on the CPU.

``_up_tiles`` is "mg_up"'s schedule: a block owns a column of ty x uz cells
in (y, z) and marches along x over `planes` output planes; the block's
coarse region of ec is staged once with the kernel's origin and extent, P
runs separably (the rows of a fine plane along x and y from the staged
region, then along z as x0 = x + P * fluid is formed), and x0, the first
sweep and the output are computed a plane at a time into rings of three
planes, each stage over the column's points and the halo ring's points as
the kernel's ``ring_point`` enumerates them. Cells outside the grid read as
0 and every neighbour product is added, as in the kernel. Held to the plain
stage ``_up_torch`` bit for bit in float32 and bfloat16, on tiles that do
not divide the grids, and to the JAX package's ``_smooth(x + _prolong(ec) *
fluid)`` in float32 (rtol 1e-6 / atol 1e-5).

Then "mg_coarse"'s routes: which sub-cycles stay resident in one block's
shared memory (``multigrid.coarse_route``, from ``coarse_smem_bytes``), what
the launcher passes for each, and the float decode of a cell index that the
kernel uses in place of integer division.

``_pre_march`` is "mg16_pre"'s schedule (``mg_pre_march``): a block owns a
column of ty x uz cells and marches along x over `planes` planes; x1 =
damp * inv_diag * b is formed once a point, a plane at a time on the column
+ 1, and the second sweep of plane q - 1 reads the planes q - 2, q - 1, q
of x1. ``_restrict_march`` is "mg_restrict"'s and "mg16_restrict"'s
(``mg_restrict_march``): a block owns a column of ty/2 x uz/2 coarse cells
and marches over `planes` coarse planes; x is staged a plane at a time on
the fine column + 2, the residual formed once a point on the fine column +
1, two new fine planes a step, and R runs as three separable passes of rows
formed once each: along x from the four residual planes, along y, then
along z, times 1/8 and the coarse fluid. Both are held to the plain stages ``_pre_torch`` and
``_restrict_residual_torch`` bit for bit in float32 and bfloat16, on tiles
that do not divide the grids, and in float32 to the JAX package's
``_smooth(lv, 0, b, _PRE_SMOOTH)`` and ``_restrict(lc, residual(lv, x, b))``
(rtol 1e-6 / atol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu.sim import multigrid
from libfluid_tpu_torch.sim import kernels as t_kernels
from libfluid_tpu_torch.sim import multigrid as t_multigrid

from test_torch_vcycle import SHAPES, _cell_types, _rhs

torch.set_num_threads(1)

# (rows, z cells, planes) of a block: small odd tiles, and the kernel's
# largest column at its longest march
TILES = {"4x8x3": (4, 8, 3), "16x32x16": (16, 32, 16)}


def _ring_point(h, ry, rz, w):
    """``ring_point`` of vcycle.cu: point h of the ring of width w around
    the column in a region of ry x rz points."""
    band = w * rz
    if h < 2 * band:
        r = h // rz
        return (r if r < w else ry - 2 * w + r), h - r * rz
    h -= 2 * band
    r, c = divmod(h, 2 * w)
    return w + r, (c if c < w else rz - 2 * w + c)


def _points(ty, uz, w):
    """The column's points, then the ring's, in a region with a halo of w."""
    ry, rz = ty + 2 * w, uz + 2 * w
    inner = [(w + a, w + c) for a in range(ty) for c in range(uz)]
    ring = [_ring_point(h, ry, rz, w) for h in range(ry * rz - ty * uz)]
    assert len(set(inner + ring)) == ry * rz  # each point once
    return torch.tensor(inner + ring).T


def _rows(i, n):
    """prolong_rows for a tensor of fine rows: the near and far coarse rows."""
    near = i // 2
    far = torch.where(i % 2 == 1, torch.clamp(near + 1, max=n - 1), torch.clamp(near - 1, min=0))
    return near, far


def _up_tiles(level, x, ec, b, ty, uz, planes):
    """The "mg_up" kernel's schedule (see the module docstring)."""
    dt = x.dtype
    nx, ny, nz = x.shape
    cx, cy, cz = ec.shape
    damp = t_multigrid._weak(t_multigrid._SMOOTH_DAMP, dt)
    scale = level.scale
    ex, ey, ez = planes // 2 + 5, ty // 2 + 4, uz // 2 + 4
    h = 40  # every array padded with zeros past the largest region: cells
    # outside the grid read as 0

    def pad(a):
        return torch.nn.functional.pad(a.float(), (h, h, h, h, h, h)).to(dt)

    xp_, bp, fp, dp, ip = (pad(a) for a in (x, b, level.fluid, level.diag, level.inv_diag))
    cup, cvp, cwp = (pad(a) for a in (level.couple_u, level.couple_v, level.couple_w))
    ecp = pad(ec)
    p0, p1 = _points(ty, uz, 2), _points(ty, uz, 1)
    out = torch.full_like(x, float("nan"))
    nan = float("nan")
    for xa in range(0, nx, planes):
        xe = min(xa + planes, nx)
        for y0 in range(0, ny, ty):
            for z0 in range(0, nz, uz):
                ex0, ey0, ez0 = (xa - 2) // 2 - 1, y0 // 2 - 2, z0 // 2 - 2
                # the staged coarse region: zeros outside the coarse grid
                se = ecp[h + ex0:h + ex0 + ex, h + ey0:h + ey0 + ey, h + ez0:h + ez0 + ez]
                assert se.shape == (ex, ey, ez)
                # region rows and columns: x0 on the column + 2, s1 on + 1
                j0 = torch.arange(y0 - 2, y0 + ty + 2)
                k0 = torch.arange(z0 - 2, z0 + uz + 2)
                in0 = ((j0 >= 0) & (j0 < ny))[:, None] & ((k0 >= 0) & (k0 < nz))[None, :]
                jn, jf = _rows(j0.clamp(0, ny - 1), cy)
                kn, kf = _rows(k0.clamp(0, nz - 1), cz)
                j1, k1 = j0[1:-1], k0[1:-1]
                in1 = in0[1:-1, 1:-1]
                x0s, s1s = {}, {}
                for q in range(xa - 2, xe + 2):
                    # x0 of plane q, over the column's points and the ring's
                    x0 = torch.full((ty + 4, uz + 4), nan, dtype=dt)
                    v = torch.zeros_like(x0)
                    if 0 <= q < nx:
                        inr, ifr = _rows(torch.tensor(q), cx)
                        assert 0 <= int(ifr) - ex0 < ex and 0 <= int(inr) - ex0 < ex
                        a = 0.75 * se[int(inr) - ex0] + 0.25 * se[int(ifr) - ex0]  # along x
                        pb = 0.75 * a[jn - ey0] + 0.25 * a[jf - ey0]  # along y: (rows, coarse K)
                        pz = 0.75 * pb[:, kn - ez0] + 0.25 * pb[:, kf - ez0]  # along z
                        g = (slice(q + h, q + h + 1), slice(y0 - 2 + h, y0 + ty + 2 + h),
                             slice(z0 - 2 + h, z0 + uz + 2 + h))
                        v = xp_[g][0] + pz * fp[g][0]
                        v = torch.where(in0, v, torch.zeros_like(v))
                    x0[p0[0], p0[1]] = v[p0[0], p0[1]]
                    x0s[q] = x0
                    p = q - 1
                    if p >= xa - 1:  # the first sweep of plane p
                        s1 = torch.full((ty + 2, uz + 2), nan, dtype=dt)
                        w = torch.zeros_like(s1)
                        if 0 <= p < nx:
                            w = _sweep(x0s[p - 1], x0s[p], x0s[p + 1], p, j1, k1, h, bp, ip, dp, fp,
                                       cup, cvp, cwp, scale, damp)
                            w = torch.where(in1, w, torch.zeros_like(w))
                        s1[p1[0], p1[1]] = w[p1[0], p1[1]]
                        s1s[p] = s1
                    p = q - 2
                    if p >= xa:  # the second sweep of plane p, masked, out
                        jo, ko = j1[1:-1], k1[1:-1]
                        w = _sweep(s1s[p - 1], s1s[p], s1s[p + 1], p, jo, ko, h, bp, ip, dp, fp,
                                   cup, cvp, cwp, scale, damp)
                        f = fp[p + h, jo[0] + h:jo[-1] + h + 1, ko[0] + h:ko[-1] + h + 1]
                        w = w * f
                        ny_, nz_ = min(ny - y0, ty), min(nz - z0, uz)
                        out[p, y0:y0 + ny_, z0:z0 + nz_] = w[:ny_, :nz_]
    return out


def _ax(xm, xc, xp, p, rows, cols, h, dp, fp, cup, cvp, cwp, scale):
    """apply_at on the interior of three planes of a region (the points one
    in from its edge), the operator of plane p at `rows` x `cols`, every
    neighbour product added in apply_at's order."""
    r = slice(rows[0] + h, rows[-1] + h + 1)
    c = slice(cols[0] + h, cols[-1] + h + 1)
    r1 = slice(rows[0] + h + 1, rows[-1] + h + 2)
    c1 = slice(cols[0] + h + 1, cols[-1] + h + 2)
    ctr = xc[1:-1, 1:-1]
    nbr = torch.zeros_like(ctr)
    nbr = nbr + cup[p + h, r, c] * xm[1:-1, 1:-1]
    nbr = nbr + cup[p + h + 1, r, c] * xp[1:-1, 1:-1]
    nbr = nbr + cvp[p + h, r, c] * xc[:-2, 1:-1]
    nbr = nbr + cvp[p + h, r1, c] * xc[2:, 1:-1]
    nbr = nbr + cwp[p + h, r, c] * xc[1:-1, :-2]
    nbr = nbr + cwp[p + h, r, c1] * xc[1:-1, 2:]
    f = fp[p + h, r, c]
    return scale * (dp[p + h, r, c] * (ctr * f) - nbr) * f


def _sweep(xm, xc, xp, p, rows, cols, h, bp, ip, dp, fp, cup, cvp, cwp, scale, damp):
    """jacobi_at on the interior of three planes of a region, as :func:`_ax`."""
    r = slice(rows[0] + h, rows[-1] + h + 1)
    c = slice(cols[0] + h, cols[-1] + h + 1)
    ax = _ax(xm, xc, xp, p, rows, cols, h, dp, fp, cup, cvp, cwp, scale)
    return xc[1:-1, 1:-1] + damp * ip[p + h, r, c] * (bp[p + h, r, c] - ax)


def _up_case(name, dtype):
    """A level of `name`'s hierarchy with the x, ec and b that the up leg
    gives it: the first level, and its coarse level's random error."""
    tlevels = t_multigrid.build_levels(torch.from_numpy(_cell_types(SHAPES[name])))
    lv, lc = tlevels[0], tlevels[1]
    rng = np.random.default_rng(21)
    b = torch.from_numpy(_rhs(rng, lv))
    ec = torch.from_numpy(rng.normal(size=tuple(lc.fluid.shape)).astype(np.float32)) * lc.fluid
    x = t_multigrid._pre_torch(lv, b)
    if dtype == torch.bfloat16:
        lv = t_multigrid.MGLevel(*(a.to(dtype) for a in lv[:6]), lv.scale)
        b, ec = b.to(dtype), ec.to(dtype)
        x = t_multigrid._pre_torch(lv, b)
    return lv, x, ec, b


@pytest.mark.parametrize("tile", list(TILES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_up_tiles_equal_the_plain_stage(name, dtype, tile):
    """The kernel's schedule gives the plain stage's bits on tiles that do
    not divide the grid, in both storage types; in float32 it matches the
    JAX package's up leg."""
    lv, x, ec, b = _up_case(name, dtype)
    got = _up_tiles(lv, x, ec, b, *TILES[tile])
    want = t_multigrid._up_torch(lv, x, ec, b)
    assert not torch.isnan(got).any()
    assert float(want.float().abs().max()) > 0
    assert torch.equal(got, want)
    if dtype == torch.float32:
        jl = multigrid.build_levels(jnp.asarray(_cell_types(SHAPES[name])))[0]
        jx = jnp.asarray(x.numpy())
        ref = multigrid._smooth(jl, jx + multigrid._prolong(jnp.asarray(ec.numpy()), x.shape) * jl.fluid,
                                jnp.asarray(b.numpy()), multigrid._POST_SMOOTH)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-5)


def _padded(h, *arrays):
    """The arrays padded with h zeros on every side: cells outside the grid
    read as 0."""
    return [torch.nn.functional.pad(a.float(), (h, h, h, h, h, h)).to(a.dtype) for a in arrays]


def _pre_march(level, b, ty, uz, planes):
    """The "mg16_pre" kernel's schedule (see the module docstring)."""
    dt = b.dtype
    nx, ny, nz = b.shape
    damp = t_multigrid._weak(t_multigrid._SMOOTH_DAMP, dt)
    h = 40
    bp, ip, dp, fp, cup, cvp, cwp = _padded(h, b, level.inv_diag, level.diag, level.fluid,
                                            level.couple_u, level.couple_v, level.couple_w)
    out = torch.full_like(b, float("nan"))
    for xa in range(0, nx, planes):
        xe = min(xa + planes, nx)
        for y0 in range(0, ny, ty):
            for z0 in range(0, nz, uz):
                # x1 of a plane on the column + 1: 0 outside the grid
                js, ks = slice(y0 - 1 + h, y0 + ty + 1 + h), slice(z0 - 1 + h, z0 + uz + 1 + h)
                rows, cols = torch.arange(y0, y0 + ty), torch.arange(z0, z0 + uz)
                x1 = {}
                for q in range(xa - 1, xe + 1):
                    x1[q] = damp * ip[q + h, js, ks] * bp[q + h, js, ks]
                    p = q - 1
                    if p >= xa:  # the second sweep of plane p, masked, out
                        v = _sweep(x1[p - 1], x1[p], x1[q], p, rows, cols, h, bp, ip, dp, fp, cup, cvp,
                                   cwp, level.scale, damp)
                        v = v * fp[p + h, y0 + h:y0 + ty + h, z0 + h:z0 + uz + h]
                        ny_, nz_ = min(ny - y0, ty), min(nz - z0, uz)
                        out[p, y0:y0 + ny_, z0:z0 + nz_] = v[:ny_, :nz_]
    return out


def _restrict_march(level, level_c, x, b, ty, uz, planes):
    """The "mg_restrict" / "mg16_restrict" kernel's schedule (see the module
    docstring)."""
    dt = b.dtype
    nx, ny, nz = b.shape
    cx, cy, cz = level_c.fluid.shape
    cyb, czb = ty // 2, uz // 2  # coarse cells of a column
    h = 40
    xp_, bp, dp, fp, cup, cvp, cwp = _padded(h, x, b, level.diag, level.fluid, level.couple_u,
                                             level.couple_v, level.couple_w)
    out = torch.full_like(level_c.fluid, float("nan"))
    for ia in range(0, cx, planes):
        ie = min(ia + planes, cx)
        for J0 in range(0, cy, cyb):
            for K0 in range(0, cz, czb):
                y0, z0 = 2 * J0, 2 * K0
                rows, cols = torch.arange(y0 - 1, y0 + ty + 1), torch.arange(z0 - 1, z0 + uz + 1)
                in1 = ((rows >= 0) & (rows < ny))[:, None] & ((cols >= 0) & (cols < nz))[None, :]
                r1 = (slice(y0 - 1 + h, y0 + ty + 1 + h), slice(z0 - 1 + h, z0 + uz + 1 + h))
                # x staged a plane at a time on the column + 2
                sx = {p: xp_[p + h, y0 - 2 + h:y0 + ty + 2 + h, z0 - 2 + h:z0 + uz + 2 + h]
                      for p in range(2 * ia - 2, 2 * ie + 2)}

                def resid(p):  # the residual of fine plane p on the column + 1, once
                    if not 0 <= p < nx:
                        return torch.zeros((ty + 2, uz + 2), dtype=dt)
                    ax = _ax(sx[p - 1], sx[p], sx[p + 1], p, rows, cols, h, dp, fp, cup, cvp, cwp,
                             level.scale)
                    v = (bp[(p + h, *r1)] - ax) * fp[(p + h, *r1)]
                    return torch.where(in1, v, torch.zeros_like(v))

                r = {2 * ia - 1: resid(2 * ia - 1), 2 * ia: resid(2 * ia)}
                for s in range(ia, ie):
                    r[2 * s + 1], r[2 * s + 2] = resid(2 * s + 1), resid(2 * s + 2)
                    # R along x: a row for each point of the column + 1
                    rx = _restrict_row([r[2 * s - 1 + q] for q in range(4)], torch.tensor(s), cx)
                    # along y: coarse rows J0 .., region rows 2 Jl + q
                    jj = torch.arange(J0, J0 + cyb)[:, None]
                    ry = _restrict_row([rx[q:q + 2 * cyb:2] for q in range(4)], jj, cy)
                    # along z, times 1/8 and the coarse fluid
                    kk = torch.arange(K0, K0 + czb)[None, :]
                    rz = _restrict_row([ry[:, q:q + 2 * czb:2] for q in range(4)], kk, cz)
                    ncy, ncz = min(cy - J0, cyb), min(cz - K0, czb)
                    fc = level_c.fluid[s, J0:J0 + ncy, K0:K0 + ncz]
                    out[s, J0:J0 + ncy, K0:K0 + ncz] = rz[:ncy, :ncz] * 0.125 * fc
                    del r[2 * s - 1], r[2 * s]
    return out


def _down_case(name, dtype):
    """A level of `name`'s hierarchy, its coarse level and the b and x of its
    down leg."""
    levels32 = t_multigrid.build_levels(torch.from_numpy(_cell_types(SHAPES[name])))
    lv, lc = levels32[0], levels32[1]
    b = torch.from_numpy(_rhs(np.random.default_rng(22), lv))
    if dtype == torch.bfloat16:
        lv, lc = (t_multigrid.MGLevel(*(a.to(dtype) for a in lev[:6]), lev.scale) for lev in (lv, lc))
        b = b.to(dtype)
    return lv, lc, b, t_multigrid._pre_torch(lv, b)


@pytest.mark.parametrize("tile", list(TILES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_pre_march_equals_the_plain_stage(name, dtype, tile):
    """"mg16_pre"'s schedule gives the plain stage's bits on tiles that do
    not divide the grid, in both storage types; in float32 it matches the
    JAX package's pre-smoothing."""
    lv, _, b, want = _down_case(name, dtype)
    got = _pre_march(lv, b, *TILES[tile])
    assert not torch.isnan(got).any()
    assert float(want.float().abs().max()) > 0
    assert torch.equal(got, want)
    if dtype == torch.float32:
        jl = multigrid.build_levels(jnp.asarray(_cell_types(SHAPES[name])))[0]
        jb = jnp.asarray(b.numpy())
        ref = multigrid._smooth(jl, jnp.zeros_like(jb), jb, multigrid._PRE_SMOOTH)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("tile", list(TILES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_restrict_march_equals_the_plain_stage(name, dtype, tile):
    """"mg(16)_restrict"'s schedule (x staged once, the residual once a point,
    R as three separable passes of rows) gives the plain stage's bits on
    tiles that do not divide the grid, odd axes zero-padded, in both storage
    types; in float32 it matches the JAX package's restriction of the
    residual."""
    lv, lc, b, x = _down_case(name, dtype)
    got = _restrict_march(lv, lc, x, b, *TILES[tile])
    want = t_multigrid._restrict_residual_torch(lv, lc, x, b)
    assert not torch.isnan(got).any()
    assert float(want.float().abs().max()) > 0
    assert torch.equal(got, want)
    if dtype == torch.float32:
        jlv, jlc = multigrid.build_levels(jnp.asarray(_cell_types(SHAPES[name])))[:2]
        ref = multigrid._restrict(jlc, multigrid.residual(jlv, jnp.asarray(x.numpy()), jnp.asarray(b.numpy())))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("cells,dtype,route,nbytes", [
    ([16 ** 3, 8 ** 3], torch.float32, "shared", 82944),  # the 128^3 and 256^3 paths
    ([16 ** 3, 8 ** 3], torch.bfloat16, "shared", 46080),
    ([13 ** 3, 7 ** 3], torch.float32, "shared", 45720),  # testbed setup 4's 50^3
    ([13 ** 3, 7 ** 3], torch.bfloat16, "shared", 25400),
    ([40 * 36 * 8], torch.float32, "shared", 207360),  # a thin grid's one level
    ([40 * 36 * 8], torch.bfloat16, "shared", 115200),
    ([48 * 40 * 8], torch.float32, "device", 276480),
    ([48 * 40 * 8], torch.bfloat16, "shared", 153600),
    ([32 ** 3], torch.float32, "device", 589824),  # the most one block takes
    ([32 ** 3], torch.bfloat16, "device", 327680),
], ids=["16+8-float32", "16+8-bfloat16", "13+7-float32", "13+7-bfloat16", "40x36x8-float32",
        "40x36x8-bfloat16", "48x40x8-float32", "48x40x8-bfloat16", "32^3-float32", "32^3-bfloat16"])
def test_coarse_route_by_the_byte_count(cells, dtype, route, nbytes):
    """A sub-cycle stays in shared memory when its levels' inv_diag, b, two
    x buffers and 16-bit mask word a cell fit one block's 227 KB."""
    assert t_multigrid.coarse_smem_bytes(cells, dtype) == nbytes
    assert t_multigrid.coarse_route(cells, dtype) == route
    assert (nbytes <= t_multigrid._BLOCK_SMEM_MAX) == (route == "shared")


@pytest.mark.parametrize("shape,route", [((16, 16, 16), "shared"), ((128, 128, 16), "device")])
def test_coarse_launch_passes_its_route(shape, route, monkeypatch):
    """The launcher gives the kernel the resident bytes and no scratch on
    route "shared", and 0 bytes with the scratch on route "device"; both
    launch "mg_coarse" and nothing else."""
    launched = []
    monkeypatch.setattr(t_kernels, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(t_kernels, "launch", lambda kernel, entry, *args: launched.append((kernel, args)))
    tlevels = t_multigrid.build_levels(torch.from_numpy(_cell_types(shape)))
    first = t_multigrid.first_coarse_level(tlevels)
    sizes = [lv.fluid.numel() for lv in tlevels[first:]]
    b = torch.zeros(tlevels[first].fluid.shape)
    t_multigrid.coarse_cycle(tlevels, b, first)
    (kernel, args), = launched
    assert kernel == "mg_coarse"
    scratch, smem = args[5], args[-1]
    if route == "shared":
        assert smem == t_multigrid.coarse_smem_bytes(sizes, torch.float32) and scratch is None
    else:
        assert smem == 0 and scratch.numel() == 3 * sum(sizes) - sizes[0]
    assert t_multigrid.coarse_route(sizes, torch.float32) == route


def test_coarse_decode_is_exact():
    """"mg_coarse" finds a cell's (i, j, k) as floor((c + 0.5) * (1 / n)) in
    float32 (no rounded multiply-add): exact for every cell of every level
    the kernel takes (at most 2^15 cells) and any row length up to 64."""
    c = np.arange(1 << 15, dtype=np.int64)
    cf = c.astype(np.float32) + np.float32(0.5)
    for n in range(1, 64 * 64 + 1):
        q = (cf * (np.float32(1.0) / np.float32(n))).astype(np.int64)
        assert np.array_equal(q, c // n), n


def _rows4(c, n_fine, n_coarse):
    """The four fine rows 2J-1 .. 2J+2 that coarse row J reads, clamped where
    the edge fold does not read them (``mg_coarse``'s restriction)."""
    return [torch.clamp(2 * c - 1, min=0), 2 * c, 2 * c + 1, torch.clamp(2 * c + 2, max=2 * n_coarse - 1)]


def _restrict_row(f, j, nc):
    """restrict_row of vcycle.cu on tensors: J's conditions as selects."""
    t = 0.75 * (f[1] + f[2])
    t = torch.where(j < nc - 1, t + 0.25 * f[3], t)
    t = torch.where(j == 0, t + 0.25 * f[1], t)
    t = torch.where(j > 0, t + 0.25 * f[0], t)
    return torch.where(j == nc - 1, t + 0.25 * f[2], t)


def _coarse_restrict(level_c, r):
    """"mg_coarse"'s restriction: along x and y into (cx, cy, nz) (a value a
    coarse (ci, cj) and fine k), then along z, times 1/8 and the coarse
    fluid; rows past an odd edge read 0."""
    cx, cy, cz = level_c.fluid.shape
    nx, ny, nz = r.shape
    rp = torch.zeros((2 * cx, 2 * cy, 2 * cz), dtype=r.dtype)
    rp[:nx, :ny, :nz] = r
    ci = torch.arange(cx)[:, None, None, None]
    cj = torch.arange(cy)[None, :, None]
    jr = torch.stack(_rows4(torch.arange(cy), ny, cy))  # (4, cy)
    rows_x = _rows4(torch.arange(cx), nx, cx)
    v = [rp[rows_x[a]][:, jr] for a in range(4)]  # each (cx, 4, cy, 2cz): the four j rows
    vx = _restrict_row(v, ci, cx)  # along x: (cx, 4, cy, 2cz)
    rxy = _restrict_row([vx[:, q] for q in range(4)], cj, cy)  # along y: (cx, cy, 2cz)
    ck = torch.arange(cz)
    w = [rxy[:, :, k] for k in _rows4(ck, nz, cz)]
    return _restrict_row(w, ck, cz) * 0.125 * level_c.fluid


def _coarse_prolong_add(level, x, ec):
    """"mg_coarse"'s prolongation: along x and y into (nx, ny, cz), then along
    z, added to x."""
    nx, ny, nz = x.shape
    cx, cy, cz = ec.shape
    near_i, far_i = _rows(torch.arange(nx), cx)
    near_j, far_j = _rows(torch.arange(ny), cy)
    near_k, far_k = _rows(torch.arange(nz), cz)
    en = 0.75 * ec[near_i][:, near_j] + 0.25 * ec[far_i][:, near_j]
    ef = 0.75 * ec[near_i][:, far_j] + 0.25 * ec[far_i][:, far_j]
    pxy = 0.75 * en + 0.25 * ef
    return x + (0.75 * pxy[:, :, near_k] + 0.25 * pxy[:, :, far_k]) * level.fluid


def _word_sweep(level, x, b, damp):
    """A damped-Jacobi sweep as "mg_coarse" runs it on its resident levels:
    a neighbour is added only where the face joining it has coupling 1."""
    nbr = torch.zeros_like(x)
    for axis in range(3):
        c = (level.couple_u, level.couple_v, level.couple_w)[axis]
        n = x.shape[axis]
        lo = t_multigrid._sl(c, axis, 0, n)  # the cell's lower face
        hi = t_multigrid._sl(c, axis, 1, n + 1)
        pad = torch.nn.functional.pad(x.float(), (1, 1, 1, 1, 1, 1)).to(x.dtype)
        core = [slice(1, -1)] * 3
        for face, shift in ((lo, 0), (hi, 2)):
            idx = list(core)
            idx[axis] = slice(shift, shift + n)
            nbr = torch.where(face != 0, nbr + pad[tuple(idx)], nbr)
    ax = level.scale * (level.diag * (x * level.fluid) - nbr) * level.fluid
    return x + damp * level.inv_diag * (b - ax)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_coarse_passes_equal_the_plain_ones(name, dtype):
    """"mg_coarse"'s separable restriction and prolongation, and its sweep
    that adds only the neighbours whose face has coupling 1, give the
    plain stages' bits on every level, in both storage types."""
    levels32 = t_multigrid.build_levels(torch.from_numpy(_cell_types(SHAPES[name])))
    tlevels = [t_multigrid.MGLevel(*(a.to(dtype) for a in lv[:6]), lv.scale) for lv in levels32]
    rng = np.random.default_rng(23)
    damp = t_multigrid._weak(t_multigrid._SMOOTH_DAMP, dtype)
    for lv32, lv, lc in zip(levels32, tlevels, tlevels[1:]):
        b = torch.from_numpy(_rhs(rng, lv32)).to(dtype)
        x = t_multigrid._pre_torch(lv, b)
        r = t_multigrid._stencil_torch(lv, x, b, t_multigrid.MODE_RESIDUAL, 0.0) * lv.fluid
        want = t_multigrid._restrict(lc, r)
        assert float(want.float().abs().max()) > 0
        assert torch.equal(_coarse_restrict(lc, r), want)
        ec = torch.from_numpy(rng.normal(size=tuple(lc.fluid.shape)).astype(np.float32)).to(dtype) * lc.fluid
        assert torch.equal(_coarse_prolong_add(lv, x, ec), x + t_multigrid._prolong(ec, x.shape) * lv.fluid)
        want = t_multigrid._stencil_torch(lv, x, b, t_multigrid.MODE_JACOBI, damp)
        assert torch.equal(_word_sweep(lv, x, b, damp), want)
