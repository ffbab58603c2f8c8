"""The closed-form vector-Jacobian product of the mesher's node pass
(``surface._sample_surface_vjp_torch``, the arithmetic kernel F' implements:
a node pass, then a gather per particle) against ``jax.vjp`` of the JAX
package's scatter oracle ``_sample_surface_jnp`` and against the port's own
autograd of the plain version, on numpy-seeded particles; a numpy model of
the kernel's slab algorithm, node words formed from the kept node sums,
against ``jax.vjp`` of the oracle; and the plain form of the forward that
keeps those sums.

Tolerances, as shares of the largest component of the reference cotangent:
2e-4 against the two float32 references and 1e-5 against the plain autograd
in float64. The float32 references carry the noise: their W and X
cotangents, a . x_p and a . avg, cancel at world coordinates under 1 / W of
a node that one far particle reaches (1.0e-4 from the float64 result with a
support of one cell here), where the closed form works on differences of the
support's size (1e-6 from it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu.config import MesherConfig
from libfluid_tpu.mesher import surface
from libfluid_tpu_torch.config import MesherConfig as TMesherConfig
from libfluid_tpu_torch.mesher import surface as t_surface
from libfluid_tpu_torch.sim import kernels as t_kernels

torch.set_num_threads(1)

GRID, H, OFFSET = (8, 6, 7), 0.5, (-1.0, -0.5, 0.25)
RTOL, RTOL_F64 = 2e-4, 1e-5


def _cfgs(extent):
    kw = dict(grid_size=GRID, cell_size=H, grid_offset=OFFSET, particle_extent=extent,
              particle_radius=extent / 4)
    return MesherConfig(**kw), TMesherConfig(**kw)


def _node(i, j, l):
    return np.asarray(OFFSET) + np.array([i, j, l]) * H


def _particles(case: str, extent: float):
    """A cloud over two thirds of the grid (the rest stays empty), then the
    case's particle as the last row; returns (positions, active, its row)."""
    rng = np.random.default_rng(17)
    size = np.array(GRID) * H
    pos = np.asarray(OFFSET) + rng.uniform(0.0, 1.0, (300, 3)) * size * np.array([0.66, 1.0, 1.0])
    active = np.ones(pos.shape[0] + 1, bool)
    special = {
        "random": pos[0] + 0.01,
        "on-a-node": _node(3, 2, 2),
        "lone-on-a-node": _node(8, 6, 7),                     # the far corner, no other near
        "at-extent": _node(3, 2, 2) + np.array([extent, 0.0, 0.0]),
        "outside-in-padding": _node(0, 2, 3) - np.array([0.6 * extent, 0.0, 0.1]),
        "beyond-padding": _node(0, 2, 3) - np.array([3.0 * extent + 1.0, 0.0, 0.0]),
        "inactive": pos[1] + 0.02,
        "no-particle": pos[0],
    }[case]
    if case == "lone-on-a-node":
        pos = pos[np.linalg.norm(pos - special, axis=1) > extent + 0.1]
        active = np.ones(pos.shape[0] + 1, bool)
    if case == "inactive":
        active[-1] = False
        active[::7] = False
    if case == "no-particle":
        active[:] = False
    pos = np.concatenate([pos, special[None]]).astype(np.float32)
    return pos, active, pos.shape[0] - 1


@pytest.mark.parametrize("extent", [0.5, 1.0], ids=["support-1", "support-2"])
@pytest.mark.parametrize("case", ["random", "on-a-node", "lone-on-a-node", "at-extent",
                                  "outside-in-padding", "beyond-padding", "inactive",
                                  "no-particle"])
def test_surface_vjp_closed_form_matches_jax_and_autograd(case, extent):
    cfg, tcfg = _cfgs(extent)
    pos, active, row = _particles(case, extent)
    rng = np.random.default_rng(3)
    g = rng.normal(size=tuple(n + 1 for n in GRID)).astype(np.float32)
    # eager: compiling the oracle's unrolled scatters takes longer than running them
    _, vjp = jax.vjp(lambda p: surface._sample_surface_jnp(p, jnp.asarray(active), cfg, extent / 4),
                     jnp.asarray(pos))
    (want,) = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    tp, ta, tg = torch.from_numpy(pos), torch.from_numpy(active), torch.from_numpy(g)
    got = t_surface._sample_surface_vjp_torch(tp, ta, tg, tcfg, extent / 4).numpy()
    assert np.isfinite(got).all()

    t_kernels.reset_launches()
    leaf = tp.clone().requires_grad_()
    (auto,) = torch.autograd.grad(t_surface.sample_surface(leaf, ta, tcfg, extent / 4), leaf, tg)
    assert not any(t_kernels.LAUNCHES[k] for k in ("surface", "surface_keep", "surface_bwd"))

    leaf = tp.double().requires_grad_()
    (auto64,) = torch.autograd.grad(
        t_surface._sample_surface_torch(leaf, ta, tcfg, extent / 4), leaf, tg.double())

    for ref, what, rtol in ((want, "jax.vjp", RTOL), (auto.numpy(), "the plain autograd", RTOL),
                            (auto64.numpy(), "the plain autograd in float64", RTOL_F64)):
        scale = float(np.max(np.abs(ref)))
        if case == "no-particle":
            assert scale == 0.0 and not got.any()
            continue
        assert scale > 0
        err = float(np.max(np.abs(got - ref))) / scale
        assert err < rtol, (what, err)
    if case in ("inactive", "beyond-padding"):
        assert not got[row].any() and not want[row].any()
    if case in ("random", "on-a-node", "outside-in-padding"):
        assert np.abs(got[row]).max() > 1e-3 * np.abs(want).max()  # the placed particle is live
    if case == "at-extent":
        # the node at exactly `extent` has kl = 0 and passes nothing; the
        # particle still feels the nodes nearer to it
        d = pos[row] - _node(3, 2, 2).astype(np.float32)
        assert np.float32(1.0) - np.float32(d @ d) / np.float32(extent * extent) == 0.0


def _node_words(sums, g, cfg):
    """Kernel F''s node words (a_n, b_n) in numpy, float32, in its
    expression order, from the kept node sums (W, X) and the cotangent g of
    the node values: zeros where W = 0."""
    f32 = np.float32
    nodes = g.shape
    idx = np.stack(np.meshgrid(*(np.arange(n) for n in nodes), indexing="ij"), -1).astype(f32)
    x_n = np.asarray(cfg.grid_offset, f32) + idx * f32(cfg.cell_size)
    w_c = np.maximum(sums[..., 0], f32(1e-30))
    d = sums[..., 1:] / w_c[..., None] - x_n
    norm = np.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2] + f32(1e-30))
    a = (g / (norm * w_c))[..., None] * d
    ab = np.concatenate([a, (a[..., 0] * d[..., 0] + a[..., 1] * d[..., 1] + a[..., 2] * d[..., 2])[..., None]], -1)
    return np.where((sums[..., 0] > 0)[..., None], ab, f32(0.0))


def _slab_gather(pos, active, sums, g, cfg, slab_nodes, tb=8):
    """Kernel F' (``csrc/surface_bwd.cu``) in numpy, float32 throughout: a
    block per tile of tb^3 bins of the padded bin grid; the tile's rows of
    bins as one list of the sorted particles; the box of tb + 2 cr - 1 nodes
    an axis that the tile reaches, its node words formed from the kept sums
    (:func:`_node_words`) as it is staged, whole where it fits `slab_nodes`
    words, else a slab of (x, y) lines at a time in line order, each
    particle's window clipped to the slab; a particle summing its window x,
    y, z ascending. Returns the cotangents in the particles' order and the
    most slabs a tile took."""
    f32 = np.float32
    pos_s, starts, order = (t.numpy() for t in t_surface.bin_particles(
        torch.from_numpy(pos), torch.from_numpy(active), cfg))
    cr = t_surface._support_cells(cfg)
    n2 = 2 * cr
    mx, my, mz = cfg.grid_size
    bx_n, by_n, bz_n = mx + n2, my + n2, mz + n2
    h = f32(cfg.cell_size)
    off = np.asarray(cfg.grid_offset, f32)
    inv_ext2 = f32(1.0) / f32(cfg.particle_extent**2)
    slope = f32(-6.0) * inv_ext2
    w = tb + n2 - 1
    lines = w * w
    sl = lines if w**3 <= slab_nodes else min(lines, slab_nodes // w)
    ab = _node_words(sums, g, cfg)
    out = np.zeros_like(pos_s)
    most_slabs = 0
    for t0x in range(0, bx_n, tb):
        for t0y in range(0, by_n, tb):
            for t0z in range(0, bz_n, tb):
                glo, n = np.zeros(tb * tb, np.int64), np.zeros(tb * tb, np.int64)
                lstart = np.zeros((tb * tb, tb + 1), np.int64)
                for r in range(tb * tb):
                    bx, by = t0x + r // tb, t0y + r % tb
                    if bx < bx_n and by < by_n:
                        row = (bx * by_n + by) * bz_n
                        ends = starts[[row + min(t0z + z, bz_n) for z in range(tb + 1)]]
                        glo[r], n[r] = ends[0], ends[-1] - ends[0]
                        lstart[r] = ends - ends[0]
                rb = np.concatenate([[0], np.cumsum(n)])
                total = int(rb[-1])
                if total == 0:
                    continue
                lstart += rb[:-1, None]
                e = np.arange(total)
                r = np.searchsorted(rb[:-1], e, side="right") - 1
                lz0 = np.array([np.searchsorted(lstart[ri, :tb], ei, side="right") - 1
                                for ri, ei in zip(r, e)])
                lx0, ly0 = r // tb, r % tb
                rows = glo[r] + e - rb[r]
                p = pos_s[rows]
                n0 = np.array([t0x, t0y, t0z]) - n2 + 1
                acc = np.zeros((total, 3), f32)
                slabs = 0
                for s0 in range(0, lines, sl):  # the lines [s0, s1)
                    s1 = min(s0 + sl, lines)
                    slabs += 1
                    line = np.arange(s0, s1)[:, None]
                    a, b = n0[0] + line // w, n0[1] + line % w
                    c = n0[2] + np.arange(w)[None, :]
                    inside = (a >= 0) & (a <= mx) & (b >= 0) & (b <= my) & (c >= 0) & (c <= mz)
                    nodes = np.where(inside[..., None],
                                     ab[np.clip(a, 0, mx), np.clip(b, 0, my), np.clip(c, 0, mz)], f32(0.0))
                    for dlx in range(n2):
                        lx = lx0 + dlx
                        y_lo, y_hi = np.maximum(ly0, s0 - lx * w), np.minimum(ly0 + n2, s1 - lx * w)
                        dx = p[:, 0] - (off[0] + (n0[0] + lx).astype(f32) * h)
                        for dly in range(n2):
                            ly = ly0 + dly
                            live = (ly >= y_lo) & (ly < y_hi)
                            dy = p[:, 1] - (off[1] + (n0[1] + ly).astype(f32) * h)
                            dxy = dx * dx + dy * dy
                            at = np.where(live, lx * w + ly - s0, 0)
                            for dlz in range(n2):
                                lz = lz0 + dlz
                                word = nodes[at, lz]
                                dz = p[:, 2] - (off[2] + (n0[2] + lz).astype(f32) * h)
                                kl = np.maximum(f32(1.0) - (dxy + dz * dz) * inv_ext2, f32(0.0))
                                k2 = kl * kl
                                t = (word[:, 0] * dx + word[:, 1] * dy + word[:, 2] * dz - word[:, 3]) * (k2 * slope)
                                k3 = k2 * kl
                                step = np.stack([t * dx + word[:, 0] * k3, t * dy + word[:, 1] * k3,
                                                 t * dz + word[:, 2] * k3], axis=1)
                                acc = np.where(live[:, None], acc + step, acc)
                most_slabs = max(most_slabs, slabs)
                out[rows] = acc
    back = np.empty_like(out)
    back[order] = out
    return back, most_slabs


@pytest.mark.parametrize("extent,slab_nodes", [(2.5, 3584), (1.0, 40)],
                         ids=["support-5-kernel-slabs", "support-2-small-slabs"])
def test_surface_bwd_slab_algorithm_matches_jax(extent, slab_nodes):
    """The particle part of kernel F' where the box of nodes does not fit
    shared memory and is staged a slab of lines at a time: at a support of 5
    cells with the kernel's own 3584 words (the first support that takes
    slabs), and at 2 cells with slabs of 3 lines. Node sums from the plain
    form of the forward that keeps them; against ``jax.vjp`` of the scatter
    oracle, and the same bits as the box staged whole."""
    cfg, tcfg = _cfgs(extent)
    pos, active, _ = _particles("inactive", extent)
    rng = np.random.default_rng(5)
    g = rng.normal(size=tuple(n + 1 for n in GRID)).astype(np.float32)
    tp, ta = torch.from_numpy(pos), torch.from_numpy(active)
    sums = t_surface._sample_surface_keep_torch(tp, ta, tcfg, extent / 4)[1].numpy()
    got, slabs = _slab_gather(pos, active, sums, g, tcfg, slab_nodes)
    assert slabs > 1
    # eager: compiling the oracle's unrolled scatters takes longer than running them
    _, vjp = jax.vjp(lambda p: surface._sample_surface_jnp(p, jnp.asarray(active), cfg, extent / 4),
                     jnp.asarray(pos))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    scale = float(np.max(np.abs(want)))
    assert scale > 0
    assert float(np.max(np.abs(got - want))) / scale < RTOL
    assert not got[~active].any()
    whole, slabs = _slab_gather(pos, active, sums, g, tcfg, 1 << 30)
    assert slabs == 1
    np.testing.assert_array_equal(got, whole)


@pytest.mark.parametrize("extent", [0.5, 1.0], ids=["support-1", "support-2"])
@pytest.mark.parametrize("case", ["random", "lone-on-a-node", "outside-in-padding", "no-particle"])
def test_keep_form_returns_the_values_and_the_node_sums(case, extent):
    """The plain form of ``surface_keep`` (the forward that wants a
    gradient) returns the plain forward's values and :func:`_node_sums`'s
    (W, X), zeros where no particle reaches; the node words formed from
    those sums equal :func:`_node_cotangents_torch`'s, and the kernel's
    expression order (:func:`_node_words`) gives them within 1e-5 where
    W > 1e-3 (a node's words carry 1 / W)."""
    _, tcfg = _cfgs(extent)
    pos, active, _ = _particles(case, extent)
    rng = np.random.default_rng(9)
    g = rng.normal(size=tuple(n + 1 for n in GRID)).astype(np.float32)
    tp, ta, tg = torch.from_numpy(pos), torch.from_numpy(active), torch.from_numpy(g)
    values, sums = t_surface._sample_surface_keep_torch(tp, ta, tcfg, extent / 4)
    assert torch.equal(values, t_surface._sample_surface_torch(tp, ta, tcfg, extent / 4))
    weight, moments = t_surface._node_sums(tp, ta, tcfg)
    assert sums.shape == weight.shape + (4,)
    assert torch.equal(sums[..., 0], weight) and torch.equal(sums[..., 1:], moments)
    assert not sums[weight == 0].any()
    words = t_surface._node_words_torch(sums, tg, tcfg)
    assert torch.equal(words, t_surface._node_cotangents_torch(tp, ta, tg, tcfg))
    if case == "no-particle":
        assert not words.any() and bool((values == 1.0).all())
        return
    well = (weight > 1e-3).numpy()
    assert well.any()
    model = _node_words(sums.numpy(), g, tcfg)
    scale = float(np.abs(words.numpy()[well]).max())
    assert float(np.abs(model[well] - words.numpy()[well]).max()) < 1e-5 * scale
    assert not model[~(weight > 0).numpy()].any()


def test_bin_order_puts_the_result_back():
    """``bin_particles`` returns the sort's order with the sorted positions
    and the CSR starts: kernel F' computes in bin order and the wrapper writes
    back through it."""
    _, tcfg = _cfgs(1.0)
    pos, active, _ = _particles("inactive", 1.0)
    tp, ta = torch.from_numpy(pos), torch.from_numpy(active)
    pos_s, starts, order = t_surface.bin_particles(tp, ta, tcfg)
    assert torch.equal(pos_s, tp[order])
    assert sorted(order.tolist()) == list(range(pos.shape[0]))
    binned = int(starts[-1])
    assert binned == int(ta.sum())  # every active particle here lies inside the padded grid
    assert bool(ta[order[:binned]].all()) and not bool(ta[order[binned:]].any())
    back = torch.empty_like(tp)
    back[order] = pos_s
    assert torch.equal(back, tp)
