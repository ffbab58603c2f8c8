"""The port's checkpoints (``libfluid_tpu_torch.checkpoint``) on the cases
of ``tests/test_checkpoint.py`` (all but the sharded restore, whose
counterpart waits for the port's ``parallel/``): a round trip of a whole
state with its metadata, a resumed state that steps exactly as the
original, strictness about missing leaves and shapes; and the generator's
state, which carries the substeps' draws, restored. Against the JAX
package: a checkpoint written by ``libfluid_tpu.checkpoint.save`` is
restored by the port, and the reverse, every leaf the two states share
(all but JAX's ``key`` and the port's ``generator``) equal; the one
unshared leaf makes a strict restore raise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfluid_tpu import checkpoint as jcheckpoint
from libfluid_tpu.config import SimConfig as JSimConfig
from libfluid_tpu.sim.state import new_state as jnew_state
from libfluid_tpu_torch import checkpoint, sim
from libfluid_tpu_torch.config import SimConfig, TransferScheme
from libfluid_tpu_torch.sim.sources import make_source_set

torch.set_num_threads(1)


def small_cfg():
    return SimConfig(grid_size=(12, 12, 12), gravity=(0.0, -10.0, 0.0), particle_capacity=1 << 12,
                     scheme=TransferScheme.APIC)


def make_state(cfg, seed=3):
    state = sim.new_state(cfg, "cpu", seed)
    state = sim.seed_box(state, cfg, (1.0, 1.0, 1.0), (6.0, 6.0, 6.0))
    return state._replace(sources=make_source_set([[2, 8, 2]], (5.0, 0.0, 0.0), coerce_velocity=True,
                                                  device="cpu"))


def _leaves(state):
    return checkpoint._flatten(state)


def assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (key, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state()), key
        else:
            assert torch.equal(x, y), key


def test_round_trip(tmp_path):
    cfg = small_cfg()
    state, _ = sim.substep(make_state(cfg), cfg, 1.0 / 60.0)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, state, metadata={"frame": 7, "setup": 0})
    restored = checkpoint.restore(path, make_state(cfg, seed=9), device="cpu")
    assert_states_equal(state, restored)
    assert restored.generator is not state.generator
    assert checkpoint.metadata(path) == {"frame": 7, "setup": 0}


def test_resume_continues_identically(tmp_path):
    """Stepping a restored state equals stepping the original, the
    generator (the source's and the correction's draws) included."""
    cfg = small_cfg()
    state, _ = sim.substep(make_state(cfg), cfg, 1.0 / 60.0)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, state)
    restored = checkpoint.restore(path, make_state(cfg, seed=5), device="cpu")
    a, _ = sim.substep(state, cfg, 1.0 / 60.0)
    b, _ = sim.substep(restored, cfg, 1.0 / 60.0)
    assert_states_equal(a, b)


def test_missing_leaf_strictness(tmp_path):
    state = make_state(small_cfg())
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, {"position": state.position})
    with pytest.raises(KeyError):
        checkpoint.restore(path, {"position": state.position, "velocity": state.velocity}, device="cpu")
    out = checkpoint.restore(path, {"position": torch.zeros_like(state.position), "velocity": state.velocity},
                             strict=False, device="cpu")
    assert torch.equal(out["position"], state.position) and torch.equal(out["velocity"], state.velocity)


def test_shape_mismatch_rejected(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, {"x": torch.zeros((4, 3))})
    with pytest.raises(ValueError):
        checkpoint.restore(path, {"x": torch.zeros((5, 3))}, device="cpu")


def test_restore_defaults_to_the_card(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, {"x": torch.arange(3.0)})
    if torch.cuda.is_available():
        assert checkpoint.restore(path, {"x": torch.zeros(3)})["x"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device=None"):
            checkpoint.restore(path, {"x": torch.zeros(3)})
    np.testing.assert_array_equal(checkpoint.restore(path, {"x": torch.zeros(3)}, device="cpu")["x"].numpy(),
                                  [0.0, 1.0, 2.0])


def _shared_states(cfg, filled: bool):
    """A JAX state and a port state of `cfg`'s shapes with two source
    cells, their shared leaves random (seeded) where `filled`, else zeros;
    JAX's key and the port's generator keep their templates' values.
    Returns (jax state, port state, {key path: array})."""
    jstate = jnew_state(JSimConfig(grid_size=cfg.grid_size, particle_capacity=cfg.particle_capacity),
                        jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    arrays = {}
    jleaves, treedef = jax.tree_util.tree_flatten_with_path(jstate)
    for path, leaf in jleaves:
        key = jcheckpoint._leaf_key(path)
        if key == "key":
            continue
        shape = ((2,) + leaf.shape[1:]) if key.startswith("sources.") else leaf.shape
        dtype = np.dtype(leaf.dtype)
        if not filled:
            arrays[key] = np.zeros(shape, dtype)
        elif dtype == np.bool_:
            arrays[key] = rng.random(shape) < 0.5
        elif np.issubdtype(dtype, np.integer):
            arrays[key] = rng.integers(0, 3, shape).astype(dtype)
        else:
            arrays[key] = rng.normal(size=shape).astype(dtype)
    jstate = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(arrays[k]) if (k := jcheckpoint._leaf_key(p)) in arrays else leaf
                  for p, leaf in jleaves])
    template = make_state(cfg)
    pleaves = [torch.from_numpy(np.array(arrays[k])).to(leaf.dtype) if k in arrays else leaf
               for k, leaf in checkpoint._flatten(template)]
    assert {k for k, _ in checkpoint._flatten(template)} - set(arrays) == {"generator"}
    return jstate, checkpoint._unflatten(template, iter(pleaves)), arrays


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_shared_with_jax(tmp_path, direction):
    """The file layout is the JAX package's: what one package saves the
    other restores (``strict=False``: the key / generator leaf is the
    other's), every shared leaf equal; strict restores raise on it."""
    cfg = small_cfg()
    jstate, pstate, arrays = _shared_states(cfg, filled=True)
    jtemplate, ptemplate, _ = _shared_states(cfg, filled=False)
    path = str(tmp_path / "ckpt.npz")
    if direction == "jax_to_port":
        jcheckpoint.save(path, jstate, metadata={"frame": 3})
        with pytest.raises(KeyError):
            checkpoint.restore(path, ptemplate, device="cpu")
        out = checkpoint.restore(path, ptemplate, strict=False, device="cpu")
        got = {k: v for k, v in checkpoint._flatten(out)}
        assert got["generator"] is ptemplate.generator
        for key, want in arrays.items():
            assert got[key].dtype == dict(checkpoint._flatten(ptemplate))[key].dtype, key
            np.testing.assert_array_equal(got[key].numpy(), want, err_msg=key)
        assert checkpoint.metadata(path) == {"frame": 3}
    else:
        checkpoint.save(path, pstate, metadata={"frame": 3})
        with pytest.raises(KeyError):
            jcheckpoint.restore(path, jtemplate)
        out = jcheckpoint.restore(path, jtemplate, strict=False)
        got = {jcheckpoint._leaf_key(p): v for p, v in jax.tree_util.tree_flatten_with_path(out)[0]}
        np.testing.assert_array_equal(np.asarray(got["key"]), np.asarray(jtemplate.key))
        for key, want in arrays.items():
            assert np.asarray(got[key]).dtype == want.dtype, key
            np.testing.assert_array_equal(np.asarray(got[key]), want, err_msg=key)
        assert jcheckpoint.metadata(path) == {"frame": 3}
