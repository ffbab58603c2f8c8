"""Random numbers of the renderer, as a provider with one method per kind
of draw (the counterpart of the JAX package's ``jax.random`` keys).

The default, :class:`HashDraws`, is a counter-based hash keyed by a seed
taken from an explicit ``torch.Generator``: every uniform is a pure
function of (seed, what it is for, sample or stream, bounce, lane,
component), so an estimator does not depend on the schedule of the loop
that draws it, on the device, or on the batch a ray lands in. A test may
pass any object with the same methods (``jitter``, ``stream``, ``lane``),
for instance one that returns the JAX package's own numbers.

- ``jitter(sample, n, device)``: (n, 2) pixel jitter of one sample of the
  fixed-count tracer (``render``);
- ``stream(sample, strip, nstrips)``: the stream of one strip of one
  sample (of `nstrips` strips a sample, all of one size), whose
  ``bounce(i, r, device)`` gives (xi (r, 2), u (r,)) for bounce i of
  ``trace_rays`` (BSDF sample, Russian roulette) of the strip's r rays,
  keyed by each ray's index in the sample (strip * r + lane), so the image
  does not depend on the strip size;
- ``lane(sid, bounce, n)``: (L, n) uniforms of the persistent tracers, a
  pure function of (sample id, bounce) per lane; bounce -1 is the camera
  jitter.
"""

from __future__ import annotations

import torch

from libfluid_tpu_torch.sim.jitterhash import _mix32, _srl

_TAG_JITTER, _TAG_BOUNCE, _TAG_LANE = 0x1B873593, 0x0E6546B6, 0x2545F491
_U24 = 1.0 / 16777216.0  # 2^-24


def _uniform(seed: int, tag: int, *words: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in [0, 1) of broadcast int32 words: the top 24 bits
    of a chain of lowbias32 mixes (int32 wraparound arithmetic)."""
    h = _mix32(torch.full((), seed ^ tag, dtype=torch.int32, device=words[0].device))
    for w in words:
        h = _mix32(h ^ w.to(torch.int32))
    return _srl(h, 8).to(torch.float32) * _U24


class _HashStream:
    def __init__(self, seed: int, sample: int, strip: int):
        self.seed, self.sample, self.strip = seed, sample, strip

    def bounce(self, i: int, r: int, device):
        """(xi (r, 2), u (r,)) for bounce `i` of the strip's r rays."""
        ids = torch.arange(self.strip * r, (self.strip + 1) * r, dtype=torch.int32, device=device)[:, None]
        comp = torch.arange(3, dtype=torch.int32, device=device)[None, :]
        s = torch.tensor(self.sample, dtype=torch.int32, device=device)
        b = torch.tensor(i, dtype=torch.int32, device=device)
        u = _uniform(self.seed, _TAG_BOUNCE, s, b, ids, comp)
        return u[:, :2], u[:, 2]


class HashDraws:
    """Counter-based draws keyed by ``seed`` (see the module's text)."""

    def __init__(self, seed: int):
        self.seed = int(seed) & 0x7FFFFFFF

    @staticmethod
    def from_generator(generator: torch.Generator) -> "HashDraws":
        """Draws keyed by one number taken from `generator` (a CPU draw: no
        device sync)."""
        return HashDraws(int(torch.randint(0, 2**31 - 1, (), generator=generator)))

    def jitter(self, sample: int, n: int, device) -> torch.Tensor:
        ids = torch.arange(n, dtype=torch.int32, device=device)[:, None]
        comp = torch.arange(2, dtype=torch.int32, device=device)[None, :]
        s = torch.tensor(sample, dtype=torch.int32, device=device)
        return _uniform(self.seed, _TAG_JITTER, s, ids, comp)

    def stream(self, sample: int, strip: int, nstrips: int = 1) -> _HashStream:
        return _HashStream(self.seed, sample, strip)

    def lane(self, sid: torch.Tensor, bounce: torch.Tensor, n: int) -> torch.Tensor:
        comp = torch.arange(n, dtype=torch.int32, device=sid.device)[None, :]
        return _uniform(self.seed, _TAG_LANE, sid[:, None], bounce[:, None], comp)


def as_draws(rng):
    """A draws provider from `rng`: a ``torch.Generator`` keys a
    :class:`HashDraws`; anything else is taken as a provider."""
    if isinstance(rng, torch.Generator):
        return HashDraws.from_generator(rng)
    return rng


def as_stream(rng):
    """A bounce stream from `rng` for a direct call of ``trace_rays``: a
    ``torch.Generator`` keys stream 0 of a :class:`HashDraws`; anything
    else is taken as a stream."""
    if isinstance(rng, torch.Generator):
        return HashDraws.from_generator(rng).stream(0, 0)
    return rng
