"""The JAX package's own random numbers behind the port's draws interface
(``libfluid_tpu_torch.renderer.draws``), so that a port tracer and its JAX
counterpart trace the same paths: the key splits of ``render`` (per
sample, then jitter and strips), of ``trace_rays`` (per bounce, then BSDF
and roulette) and the ``fold_in`` chain of the persistent tracers."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch


def _to_torch(a, device):
    return torch.from_numpy(np.array(a)).to(device)


class JaxStream:
    """The draws of ``pathtrace.trace_rays(..., key, cfg)``."""

    def __init__(self, key, max_bounces: int):
        self.keys = jax.random.split(key, max_bounces)

    def bounce(self, i: int, r: int, device):
        k1, k2 = jax.random.split(self.keys[i])
        xi = jax.random.uniform(k1, (r, 2), jnp.float32)
        u = jax.random.uniform(k2, (r,), jnp.float32)
        return _to_torch(xi, device), _to_torch(u, device)


@functools.partial(jax.jit, static_argnums=3)
def _lane(key, sid, bounce, n):
    ks = jax.vmap(lambda s, b: jax.random.fold_in(jax.random.fold_in(key, s), b))(sid, bounce)
    return jax.vmap(lambda k: jax.random.uniform(k, (n,), jnp.float32))(ks)


class JaxDraws:
    """The draws of ``render.render(..., key)`` and
    ``pathtrace.trace_persistent(..., key)`` for `cfg`."""

    def __init__(self, key, cfg):
        self.key = key
        self.max_bounces = cfg.max_bounces
        self.sample_keys = jax.random.split(key, cfg.samples_per_pixel)

    def jitter(self, sample: int, n: int, device):
        k1, _ = jax.random.split(self.sample_keys[sample])
        return _to_torch(jax.random.uniform(k1, (n, 2)), device)

    def stream(self, sample: int, strip: int, nstrips: int = 1):
        _, k2 = jax.random.split(self.sample_keys[sample])
        ks = k2 if nstrips == 1 else jax.random.split(k2, nstrips)[strip]
        return JaxStream(ks, self.max_bounces)

    def lane(self, sid, bounce, n: int):
        s = jnp.asarray(sid.cpu().numpy().astype(np.int32))
        b = jnp.asarray(bounce.cpu().numpy().astype(np.int32))
        return _to_torch(_lane(self.key, s, b, n), sid.device)
