"""The port's ``parallel`` layer on gloo ranks (``tests/torch_ranks.py``),
mirroring ``tests/test_sharding.py``: the z halo exchange against padding,
the sharded Poisson stencil against the JAX package's dense operator, a
rank's share of a state, the sharded render on 1, 2 and 4 ranks (one image,
equal to the port's single-process ``render``), and the training step on 2
ranks equal to 1 (``__graft_entry__.dryrun_multichip``'s scene)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu.config import CellType
from libfluid_tpu.sim import pressure as j_pressure
from libfluid_tpu_torch import convert
from libfluid_tpu_torch import sim as t_sim
from libfluid_tpu_torch.config import RenderConfig, SimConfig, TransferScheme
from libfluid_tpu_torch.renderer import scenes
from libfluid_tpu_torch.renderer.render import render
import torch_ranks

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [2, 4])
def test_halo_exchange_and_apply_A(n, tmp_path):
    rng = np.random.default_rng(0)
    x = torch.arange(4 * 4 * 16, dtype=torch.float32).reshape(4, 4, 16)
    ct = np.full((16, 16, 16), CellType.AIR, np.int8)
    ct[rng.uniform(size=ct.shape) < 0.4] = CellType.FLUID
    ct[:, 0, :] = CellType.SOLID
    p = rng.normal(size=ct.shape).astype(np.float32)
    res = torch_ranks.run(n, "halo_and_apply", dict(x=x, ct=torch.from_numpy(ct), p=torch.from_numpy(p),
                                                    a_scale=0.7), tmp_path)
    zl = 16 // n
    xt = x.reshape(4, 4, n, zl)
    for k, r in enumerate(res):
        below = torch.zeros((4, 4)) if k == 0 else xt[:, :, k - 1, -1]
        above = torch.zeros((4, 4)) if k == n - 1 else xt[:, :, k + 1, 0]
        assert torch.equal(r["halo"], torch.cat([below[..., None], xt[:, :, k], above[..., None]], dim=-1))
        fill = torch.full((4, 4), -1.0)
        assert torch.equal(r["pad"][..., 0], fill if k == 0 else below)
        assert torch.equal(r["pad"][..., -1], fill if k == n - 1 else above)
    want = j_pressure.apply_A(j_pressure.build_operator(jnp.asarray(ct)), jnp.asarray(p), 0.7)
    got = torch.cat([r["apply"] for r in res], dim=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for r in res:
        np.testing.assert_allclose(float(r["dot"]), float((p.astype(np.float64) ** 2).sum()), rtol=1e-5)


def _dam_break(nz=32, capacity=1 << 12):
    cfg = SimConfig(grid_size=(16, 16, nz), cell_size=1.0, gravity=(0.0, -10.0, 0.0),
                    particle_capacity=capacity, scheme=TransferScheme.APIC)
    st = t_sim.seed_box(t_sim.new_state(cfg, "cpu"), cfg, (1.0, 1.0, 1.0), (7.0, 7.0, 7.0))
    return cfg, st


def test_shard_sim_state_is_the_ranks_block(tmp_path):
    """Rank k holds rows block k and, on a grid tall enough, z-tile k of
    u and y-tile k of w (the JAX package's layout)."""
    cfg, st = _dam_break()
    res = torch_ranks.run(2, "shard_and_gather", dict(cfg=cfg, arrays=convert.state_to_numpy(st)), tmp_path)
    for k, r in enumerate(res):
        assert torch.equal(r["rows"], st.position)
        assert torch.equal(r["u"], st.grid.u[:, :, 16 * k : 16 * (k + 1)])
        assert torch.equal(r["w"], st.grid.w[:, 8 * k : 8 * (k + 1)])


def test_sharded_render_does_not_depend_on_the_ranks(tmp_path):
    """``test_sharding.py``'s render (Cornell, 32 x 16, 2 spp, 2 bounces):
    the same image on 1, 2 and 4 ranks, and equal to ``render`` in one
    process with the same generator (its draws are keyed by the pixel too)."""
    cfg = RenderConfig(width=32, height=16, samples_per_pixel=2, max_bounces=2, ray_batch=128)
    images = [torch_ranks.run(n, "render_image", dict(scene_name="cornell_box_one_light", cfg=cfg, seed=5),
                              tmp_path)
              for n in (1, 2, 4)]
    first = images[0][0]
    assert first.shape == (16, 32, 3) and torch.isfinite(first).all() and float(first.mean()) > 0.01
    for ranks in images:
        for img in ranks:
            assert torch.equal(img, first)
    builder, cam = scenes.cornell_box_one_light(1.0, device="cpu")
    want = render(builder.finish(device="cpu"), cam, cfg, torch.Generator().manual_seed(5), device="cpu")
    np.testing.assert_allclose(first.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_training_step_two_ranks_equal_one(tmp_path):
    """dryrun_multichip's training step (16 x 16 x 32, 4 sphere proxies, a
    black target) on 1 and 2 ranks: the loss and the updated velocities
    equal. The proxies are the first 4 rows after the substep's sort, so
    4 particles seeded one a cell on the x = 0 column (the lowest cell
    indices) stand in view on the left wall, apart. With dryrun's glass
    proxies (radius 0.5, 16^2 x 1 spp, 2 bounces) the loss is finite; the
    gradient of a glass path's weight is zero almost everywhere, in the
    JAX package too (a dielectric's Fresnel weight cancels its pick). With
    proxies that emit a ramp over uv (radius 1.5, the same render) the
    initial velocities get a gradient."""
    cfg, st = _dam_break()
    for cell in [(0, y, z) for y in (5, 10) for z in (8, 14)]:
        st = t_sim.seed_func(st, cfg, cell, (1, 1, 1), lambda p: np.ones(len(p), bool), density=1)
    variants = [
        (RenderConfig(width=16, height=16, samples_per_pixel=1, max_bounces=2), "glass", 0.5),
        (RenderConfig(width=16, height=16, samples_per_pixel=1, max_bounces=2), "textured", 1.5),
    ]
    payload = dict(cfg=cfg, arrays=convert.state_to_numpy(st), variants=variants, nspheres=4, dt=1.0 / 60.0,
                   seed=3)
    one = torch_ranks.run(1, "train", payload, tmp_path)[0]
    two = torch_ranks.run(2, "train", payload, tmp_path)
    for r in two:
        for got, want in zip(r, one):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
            np.testing.assert_allclose(got["velocity"].numpy(), want["velocity"].numpy(), rtol=1e-5, atol=1e-9)
    glass, textured = one
    assert np.isfinite(glass["loss"]) and glass["loss"] > 0
    # the update is the initial (row-order) velocities minus lr * gradient,
    # as in the JAX package
    step = (textured["velocity"] - st.velocity).abs().sum(dim=1)
    assert int((step > 0).sum()) >= 4, "no gradient reached the sphere proxies"
