"""The closed-form vector-Jacobian product of the correction springs
(``correction._springs_vjp_torch``, the arithmetic kernel E' implements)
against ``jax.vjp`` of the JAX package's oracle ``_springs_jnp`` and against
the port's own autograd of the plain version, on numpy-seeded slot grids;
and kernel E''s algorithm as a numpy model (:func:`_warp_model`) against
both.

Tolerance: 1e-4 of the largest component of the reference cotangent. The
Jacobian has a 1/d^3 term, so the closest pair sets the scale, and the
oracle's form ``x_i * wsum - wnbr`` cancels at world coordinates where the
closed form works on differences; float32 leaves the two ~1e-5 apart."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu.config import SimConfig
from libfluid_tpu.sim import correction
from libfluid_tpu_torch import convert
from libfluid_tpu_torch.sim import correction as t_correction
from libfluid_tpu_torch.sim import jitterhash
from libfluid_tpu_torch.sim import kernels as t_kernels

torch.set_num_threads(1)

KC, SHAPE, H, SEED = 6, (6, 5, 7), 1.0, 4242
RE2 = H * H / 2.0
CFG = SimConfig(grid_size=SHAPE, cell_size=H, particle_capacity=64)
TCFG = convert.config_from_fields(**vars(CFG))
RTOL = 1e-4

_jax_vjp = jax.jit(lambda p, m, g: jax.vjp(
    lambda p_, m_: correction._springs_jnp(p_, m_, RE2, jnp.int32(SEED), CFG), p, m)[1](g))


def _slots(case: str):
    """Slots of random counts with in-cell positions at least 0.05 from the
    cell's faces, zeros in the empty slots, and the case's pairs placed."""
    rng = np.random.default_rng(21)
    counts = rng.integers(0, KC + 1, size=SHAPE)
    counts[2, 2, 3] = max(counts[2, 2, 3], 3)
    counts[3, 2, 3] = max(counts[3, 2, 3], 1)
    if case == "empty-grid":
        counts[:] = 0
    mask = (np.arange(KC)[:, None, None, None] < counts[None]).astype(np.float32)
    cell = np.stack(np.meshgrid(*(np.arange(n) for n in SHAPE), indexing="ij"))
    pos = (cell[:, None] + rng.uniform(0.05, 0.95, (3, KC) + SHAPE)) * H
    if case == "coincident":
        pos[:, 1, 2, 2, 3] = pos[:, 0, 2, 2, 3]          # inside a cell
        pos[:, 2, 2, 2, 3] = (3.0, 2.5, 3.5)             # on a face, and its twin
        pos[:, 0, 3, 2, 3] = (3.0, 2.5, 3.5)             # in the neighbour cell
    if case == "at-re":
        pos[:, 0, 2, 2, 3] = (2.25, 2.25, 3.5)           # |r|^2 = 0.5 = re^2 exactly
        pos[:, 1, 2, 2, 3] = (2.75, 2.75, 3.5)
    if case == "close-pair":
        pos[:, 1, 2, 2, 3] = pos[:, 0, 2, 2, 3] + np.float32(1e-2)
    pos = (pos * mask[None]).astype(np.float32)
    g = rng.normal(size=pos.shape).astype(np.float32)
    return pos, mask, g


def _assert_close(got, want, what):
    scale = float(np.max(np.abs(want)))
    if scale == 0.0:
        assert not np.any(got), what
        return
    err = float(np.max(np.abs(got - want))) / scale
    assert err < RTOL, (what, err)


@pytest.mark.parametrize("case", ["random", "coincident", "at-re", "close-pair", "empty-grid"])
def test_springs_vjp_closed_form_matches_jax_and_autograd(case):
    pos, mask, g = _slots(case)
    if case == "at-re":
        r = pos[:, 0, 2, 2, 3] - pos[:, 1, 2, 2, 3]
        assert np.float32(1.0) - np.float32(r @ r) / np.float32(RE2) == 0.0
    want_p, want_m = (np.asarray(a) for a in _jax_vjp(*(jnp.asarray(a) for a in (pos, mask, g))))
    tp, tm, tg = (torch.from_numpy(a) for a in (pos, mask, g))
    got_p, got_m = t_correction._springs_vjp_torch(tp, tm, tg, RE2, SEED, TCFG)
    _assert_close(got_p.numpy(), want_p, "d pos against jax.vjp")
    _assert_close(got_m.numpy(), want_m, "d mask against jax.vjp")
    assert not got_p.numpy()[:, mask == 0].any()  # an empty slot's position gets nothing

    # the port's own autograd of the plain version, through the Function (CPU
    # tensors take it, and count no launch)
    t_kernels.reset_launches()
    lp, lm = tp.clone().requires_grad_(), tm.clone().requires_grad_()
    out = t_correction._springs(lp, lm, SEED, (0, 0, 0), RE2, TCFG)
    auto_p, auto_m = torch.autograd.grad(out, (lp, lm), tg)
    assert t_kernels.LAUNCHES["correction_bwd"] == 0 and t_kernels.LAUNCHES["correction"] == 0
    _assert_close(got_p.numpy(), auto_p.numpy(), "d pos against the plain autograd")
    _assert_close(got_m.numpy(), auto_m.numpy(), "d mask against the plain autograd")
    if case == "coincident":
        # the jitter's part of d mask is live: another seed moves it
        other = t_correction._springs_vjp_torch(tp, tm, tg, RE2, SEED + 1, TCFG)[1].numpy()
        assert np.max(np.abs(other - got_m.numpy())) > 1e-3
    if case == "empty-grid":
        assert not got_p.any() and not got_m.any()


def test_springs_vjp_with_an_origin_and_smaller_cells():
    """A global origin for the jitter hash and a cell size that is not 1
    (the oracle is called eagerly here: one more shape)."""
    h, origin = 0.8, (5, -3, 1000)
    cfg = SimConfig(grid_size=(4, 4, 5), cell_size=h, particle_capacity=64)
    tcfg = convert.config_from_fields(**vars(cfg))
    rng = np.random.default_rng(5)
    counts = rng.integers(1, 5, size=cfg.grid_size)
    mask = (np.arange(4)[:, None, None, None] < counts[None]).astype(np.float32)
    cell = np.stack(np.meshgrid(*(np.arange(n) for n in cfg.grid_size), indexing="ij"))
    pos = (cell[:, None] + rng.uniform(0.05, 0.95, (3, 4) + cfg.grid_size)) * h
    pos[:, 1, 1, 1, 1] = pos[:, 0, 1, 1, 1]
    pos = (pos * mask[None]).astype(np.float32)
    g = rng.normal(size=pos.shape).astype(np.float32)
    re2 = h * h / 2.0
    _, vjp = jax.vjp(lambda p, m: correction._springs_jnp(
        p, m, re2, jnp.int32(99), cfg, origin=jnp.asarray(origin, jnp.int32)),
        jnp.asarray(pos), jnp.asarray(mask))
    want_p, want_m = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    got_p, got_m = t_correction._springs_vjp_torch(
        torch.from_numpy(pos), torch.from_numpy(mask), torch.from_numpy(g), re2, 99, tcfg, origin)
    _assert_close(got_p.numpy(), want_p, "d pos")
    _assert_close(got_m.numpy(), want_m, "d mask")


def test_springs_vjp_at_forty_slots():
    """40 slots a cell, more than one word of kernel E''s occupancy mask:
    the closed form against ``jax.vjp`` of the oracle, with coincident
    pairs in a cell's second word (eager oracle: one more shape)."""
    kc, shape = 40, (3, 4, 3)
    cfg = SimConfig(grid_size=shape, cell_size=H, particle_capacity=64)
    tcfg = convert.config_from_fields(**vars(cfg))
    rng = np.random.default_rng(40)
    counts = rng.integers(0, kc + 1, size=shape)
    counts[1, 2, 1] = kc
    mask = (np.arange(kc)[:, None, None, None] < counts[None]).astype(np.float32)
    cell = np.stack(np.meshgrid(*(np.arange(n) for n in shape), indexing="ij"))
    pos = (cell[:, None] + rng.uniform(0.05, 0.95, (3, kc) + shape)) * H
    pos[:, 35, 1, 2, 1] = pos[:, 3, 1, 2, 1]
    pos = (pos * mask[None]).astype(np.float32)
    g = rng.normal(size=pos.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda p, m: correction._springs_jnp(p, m, RE2, jnp.int32(SEED), cfg),
                     jnp.asarray(pos), jnp.asarray(mask))
    want_p, want_m = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    got_p, got_m = t_correction._springs_vjp_torch(
        torch.from_numpy(pos), torch.from_numpy(mask), torch.from_numpy(g), RE2, SEED, tcfg)
    _assert_close(got_p.numpy(), want_p, "d pos")
    _assert_close(got_m.numpy(), want_m, "d mask")


def _warp_model(pos, mask, g, re2, seed, origin=(0, 0, 0), tile=(2, 4, 8), word=16):
    """Kernel E''s algorithm (``csrc/correction_bwd.cu``) in numpy, float32
    throughout (the kernel's fused multiply-adds as a product and a sum): a
    block per tile of cells; the occupied slots of the tile and its one-cell
    halo staged `word` slots a cell at a time, compacted in cell order (z
    fastest) and slot order with (x, y, z, m) and (g, jitter . g); a warp a
    cell of the tile, whose 27 neighbour cells are 9 runs of three cells
    along z in the staged list; of those j's, the ones within
    re * sqrt(1.001) of the box of the cell's i's kept in order, lane l
    taking the kept j's l, l + 32, ... and summing (d x, d m) per i of the
    cell's word in its own registers; the self-pair's coincident term left
    out by its place; the butterfly xor 16, 8, 4, 2, 1 over the lanes; m_i d x
    and d m written after the first word of neighbours and the others'
    added. Returns (d pos, d mask) and counts: the j's seen and kept, the
    most passes of the lanes over a cell's kept j's."""
    f32 = np.float32
    kc, nx, ny, nz = mask.shape
    tx, ty, tz = tile
    hy, hz = ty + 2, tz + 2
    halo = (tx + 2) * hy * hz
    jg_all = np.sum(jitterhash.jitter_field(seed, kc, (nx, ny, nz), origin, torch.float32, "cpu").numpy()
                    * g, axis=0, dtype=f32)
    inv_re2 = f32(1.0) / f32(re2)
    six_re2 = f32(6.0) * inv_re2
    cut2 = f32(re2) * f32(1.001)
    d_pos = np.full(pos.shape, np.nan, f32)
    d_mask = np.full(mask.shape, np.nan, f32)
    d_pos[:, mask == 0] = 0.0
    d_mask[mask == 0] = 0.0
    counts = dict(seen=0, kept=0, passes=0)

    def slot4(k, c):
        at = (slice(None), k) + c
        return (np.array([*pos[at], mask[(k,) + c]], f32), np.array([*g[at], jg_all[(k,) + c]], f32))

    for t0x in range(0, nx, tx):
        for t0y in range(0, ny, ty):
            for t0z in range(0, nz, tz):
                if not mask[:, t0x:t0x + tx, t0y:t0y + ty, t0z:t0z + tz].any():
                    continue
                for wj in range(0, kc, word):
                    # the staged list: each halo cell's occupied slots of the word
                    first, spos, scot, occupied = [0], [], [], []
                    for h in range(halo):
                        c = (t0x - 1 + h // (hy * hz), t0y - 1 + (h // hz) % hy, t0z - 1 + h % hz)
                        inside = all(0 <= c[a] < (nx, ny, nz)[a] for a in range(3))
                        occ = [k for k in range(wj, min(wj + word, kc)) if inside and mask[(k,) + c] != 0]
                        occupied.append(occ)
                        for k in occ:
                            p4, g4 = slot4(k, c)
                            spos.append(p4)
                            scot.append(g4)
                        first.append(first[-1] + len(occ))
                    spos, scot = np.array(spos, f32).reshape(-1, 4), np.array(scot, f32).reshape(-1, 4)
                    for cl in range(tx * ty * tz):
                        c = (t0x + cl // (ty * tz), t0y + (cl // tz) % ty, t0z + cl % tz)
                        if not all(c[a] < (nx, ny, nz)[a] for a in range(3)):
                            continue
                        hc = ((cl // (ty * tz) + 1) * hy + (cl // tz) % ty + 1) * hz + cl % tz + 1
                        # the j's: the runs (dx, dy) of three cells along z, in order
                        js = np.concatenate([np.arange(first[nb - 1], first[nb + 2]) for nb in
                                             (hc + ((r // 3 - 1) * hy + r % 3 - 1) * hz for r in range(9))])
                        for wi in range(0, kc, word):
                            if wi == wj:
                                slots, self0 = occupied[hc], first[hc]
                                ip, ic = spos[self0:self0 + len(slots)], scot[self0:self0 + len(slots)]
                            else:
                                slots, self0 = [k for k in range(wi, min(wi + word, kc)) if mask[(k,) + c] != 0], None
                                both = [slot4(k, c) for k in slots]
                                ip = np.array([b[0] for b in both], f32).reshape(-1, 4)
                                ic = np.array([b[1] for b in both], f32).reshape(-1, 4)
                            ni = len(slots)
                            if ni == 0:
                                continue
                            # the j's in reach of the box of the i's
                            lo, hi = ip[:, :3].min(axis=0), ip[:, :3].max(axis=0)
                            q3 = spos[js][:, :3]
                            d = np.maximum(np.maximum(lo - q3, q3 - hi), f32(0.0))
                            near = js[d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2] < cut2]
                            acc = np.zeros((32, ni, 4), f32)
                            passes = -(-len(near) // 32)
                            counts["seen"] += len(js)
                            counts["kept"] += len(near)
                            counts["passes"] = max(counts["passes"], passes)
                            for p in range(passes):
                                lanes = np.arange(32)
                                live = p * 32 + lanes < len(near)
                                e = near[np.minimum(p * 32 + lanes, len(near) - 1)]
                                q, qg = spos[e][:, None], scot[e][:, None]  # (32, 1, 4)
                                me, mine = ip[None], ic[None]                 # (1, ni, 4)
                                ex, ey, ez = (me[..., a] - q[..., a] for a in range(3))
                                sq = ex * ex + ey * ey + ez * ez
                                coincide = sq < f32(1e-12)
                                kl = np.maximum(f32(1.0) - sq * inv_re2, f32(0.0))
                                with np.errstate(divide="ignore"):
                                    rs = np.where(coincide, f32(0.0), f32(1.0) / np.sqrt(sq))
                                kk = q[..., 3] * kl * kl * rs
                                w = kk * kl
                                w2 = -kk * (six_re2 + kl * rs * rs)
                                gx, gy, gz = (mine[..., a] - qg[..., a] for a in range(3))
                                rg = ex * gx + ey * gy + ez * gz
                                cc = w2 * rg
                                new = acc.copy()
                                for a in range(3):
                                    new[..., a] = (acc[..., a] + (w * (gx, gy, gz)[a])) + cc * (ex, ey, ez)[a]
                                new[..., 3] = acc[..., 3] + w * rg
                                place = e[:, None] - self0 if self0 is not None else np.full((32, 1), -1)
                                coin = coincide & (place != np.arange(ni)[None])
                                new[..., 3] = np.where(coin, new[..., 3] + q[..., 3] * (mine[..., 3] + qg[..., 3]),
                                                       new[..., 3])
                                acc = np.where(live[:, None, None], new, acc)
                            for o in (16, 8, 4, 2, 1):
                                acc = acc + acc[np.arange(32) ^ o]
                            for ii, k in enumerate(slots):
                                m = ip[ii, 3]
                                at = (slice(None), k) + c
                                if wj == 0:
                                    d_pos[at] = m * acc[0, ii, :3]
                                    d_mask[(k,) + c] = acc[0, ii, 3]
                                else:
                                    d_pos[at] += m * acc[0, ii, :3]
                                    d_mask[(k,) + c] += acc[0, ii, 3]
    return d_pos, d_mask, counts


def _model_slots(kc, shape, seed):
    """Slots at 40 % fill, a third of the grid empty, an empty cell inside
    the fluid, and coincident pairs: two slots of one cell, a slot on a face
    and its twin in the next cell (across a tile's edge along x), in the
    second word of slots where there is one."""
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(kc,) + shape) < 0.4).astype(np.float32)
    mask[..., : shape[2] // 3] = 0.0
    mask[:, 1, 1, shape[2] - 1] = 0.0
    mask[:, 1, 2, shape[2] // 2] = 1.0  # a full cell
    cell = np.stack(np.meshgrid(*(np.arange(n) for n in shape), indexing="ij"))
    pos = (cell[:, None] + rng.uniform(0.05, 0.95, (3, kc) + shape)).astype(np.float32)
    a, b, k2 = (1, 2, shape[2] - 2), (2, 2, shape[2] - 2), min(kc - 1, 17)
    mask[(0,) + a] = mask[(2,) + a] = mask[(k2,) + a] = mask[(1,) + b] = 1.0
    pos[(slice(None), 2) + a] = pos[(slice(None), 0) + a]
    pos[(slice(None), k2) + a] = (2.0, a[1] + 0.5, a[2] + 0.5)
    pos[(slice(None), 1) + b] = pos[(slice(None), k2) + a]
    pos = (pos * mask[None]).astype(np.float32)
    g = rng.normal(size=pos.shape).astype(np.float32)
    return pos, mask, g


@pytest.mark.parametrize("kc,shape", [(6, (6, 5, 7)), (16, (5, 6, 11)), (40, (3, 5, 10))],
                         ids=["6-slots", "16-slots", "40-slots"])
def test_warp_model_matches_jax_and_the_closed_form(kc, shape):
    """Kernel E''s algorithm as :func:`_warp_model` on a grid no tile
    divides, 210 cells at 6 slots a cell (one word), 330 at 16 (the largest
    register bucket) and 150 at 40 (three words of neighbours and of the
    cell's own slots): against ``jax.vjp`` of the oracle and the plain closed
    form (1e-4 of the largest component, as above), empty slots 0, the
    coincident pairs' d mask live, some j's left out as out of reach; and the
    same bits from another tile shape (a cell's j's are its 9 runs, whatever
    the tile)."""
    pos, mask, g = _model_slots(kc, shape, 7 + kc)
    re2 = RE2
    # the jitted oracle of the tests above where the shapes are theirs, else
    # an eager one with a global origin for the jitter hash
    seed, origin = (SEED, (0, 0, 0)) if (kc, shape) == (KC, SHAPE) else (321, (3, -2, 7))
    cfg = SimConfig(grid_size=shape, cell_size=H, particle_capacity=64)
    tcfg = convert.config_from_fields(**vars(cfg))
    got_p, got_m, counts = _warp_model(pos, mask, g, re2, seed, origin)
    assert 0 < counts["kept"] < counts["seen"]
    assert counts["passes"] > 1 or kc < 16  # some cell has more j's in reach than a warp has lanes
    assert np.isfinite(got_p).all() and np.isfinite(got_m).all()
    if (kc, shape) == (KC, SHAPE):
        want = _jax_vjp(jnp.asarray(pos), jnp.asarray(mask), jnp.asarray(g))
    else:
        _, vjp = jax.vjp(lambda p, m: correction._springs_jnp(
            p, m, re2, jnp.int32(seed), cfg, origin=jnp.asarray(origin, jnp.int32)),
            jnp.asarray(pos), jnp.asarray(mask))
        want = vjp(jnp.asarray(g))
    want_p, want_m = (np.asarray(a) for a in want)
    plain_p, plain_m = (a.numpy() for a in t_correction._springs_vjp_torch(
        torch.from_numpy(pos), torch.from_numpy(mask), torch.from_numpy(g), re2, seed, tcfg, origin))
    occ = mask != 0
    for ref_p, ref_m, what in ((want_p, want_m, "jax.vjp"), (plain_p, plain_m, "the closed form")):
        _assert_close(got_p, ref_p, f"d pos against {what}")
        _assert_close(got_m * occ, ref_m * occ, f"d mask against {what}")
    assert not got_p[:, ~occ].any() and not got_m[~occ].any()
    a = (1, 2, shape[2] - 2)
    assert abs(got_m[(0,) + a]) > 1e-3 * np.abs(got_m).max()
    other_p, other_m, _ = _warp_model(pos, mask, g, re2, seed, origin, tile=(4, 4, 4))
    np.testing.assert_array_equal(got_p, other_p)
    np.testing.assert_array_equal(got_m, other_m)
