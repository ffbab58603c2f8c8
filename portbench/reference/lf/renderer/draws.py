"""Random numbers of the renderer, as a provider with one method per kind
of draw (the counterpart of the JAX package's ``jax.random`` keys).

The default, :class:`HashDraws`, is a counter-based hash keyed by a seed
taken from an explicit ``torch.Generator``: every uniform is a pure
function of (seed, what it is for, sample or stream, bounce, lane,
component), so an estimator does not depend on the schedule of the loop
that draws it, on the device, or on the batch a ray lands in. A test may
pass any object with the same methods (``jitter``, ``stream``, ``bdpt``,
``lane``), for instance one that returns the JAX package's own numbers.

- ``jitter(sample, n, device)``: (n, 2) pixel jitter of one sample of the
  fixed-count tracer (``render``);
- ``stream(sample, strip, nstrips)``: the stream of one strip of one
  sample (of `nstrips` strips a sample, all of one size), whose
  ``bounce(i, r, device)`` gives (xi (r, 2), u (r,)) for bounce i of
  ``trace_rays`` (BSDF sample, Russian roulette) of the strip's r rays,
  keyed by each ray's index in the sample (strip * r + lane), so the image
  does not depend on the strip size;
- ``bdpt(sample, strip, nstrips)``: the stream of one strip of the
  bidirectional tracer (``bdpt.trace_rays``), keyed like ``stream``, with
  ``camera(k, r, device)`` and ``light(k, r, device)`` the (r, 2) BSDF
  draws of bounce k of the camera and the light subpath, ``emit(r,
  device)`` the (r, 2) cosine-emitted direction at the light point y0,
  and ``light_point(which, area, count, r, device)`` the light points:
  ``which`` 0 is y0 (count 1), 1 the fresh s = 1 points (count the camera
  depth), each (count * r,) indices into the scene's light slots, picked in
  proportion to `area` (the masked light areas), and (count * r, 2)
  uniforms for the point on the picked triangle; rows are set-major
  (set c, ray);
- ``lane(sid, bounce, n)``: (L, n) uniforms of the persistent tracers, a
  pure function of (sample id, bounce) per lane; bounce -1 is the camera
  jitter.
"""

from __future__ import annotations

import torch

from portbench.reference.lf.sim.jitterhash import _mix32, _srl

_TAG_JITTER, _TAG_BOUNCE, _TAG_LANE = 0x1B873593, 0x0E6546B6, 0x2545F491
# the bidirectional tracer's draws: camera and light bounces, the emitted
# direction, the light points (pick and point)
_TAG_BD_CAM, _TAG_BD_LIGHT, _TAG_BD_EMIT, _TAG_BD_POINT = 0x68E31DA4, 0x1B56C4E9, 0x5F356495, 0x3C6EF372
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


class _HashBdptStream:
    def __init__(self, seed: int, sample: int, strip: int):
        self.seed, self.sample, self.strip = seed, sample, strip

    def _u(self, tag: int, r: int, device, n: int, *words: int, sets: int = 1) -> torch.Tensor:
        """(sets * r, n) uniforms keyed by (sample, words, set, ray id)."""
        ids = torch.arange(self.strip * r, (self.strip + 1) * r, dtype=torch.int32, device=device)
        c = torch.arange(sets, dtype=torch.int32, device=device)[:, None, None]
        comp = torch.arange(n, dtype=torch.int32, device=device)[None, None, :]
        w = [torch.tensor(x, dtype=torch.int32, device=device) for x in (self.sample, *words)]
        return _uniform(self.seed, tag, *w, c, ids[None, :, None], comp).reshape(sets * r, n)

    def camera(self, k: int, r: int, device) -> torch.Tensor:
        return self._u(_TAG_BD_CAM, r, device, 2, k)

    def light(self, k: int, r: int, device) -> torch.Tensor:
        return self._u(_TAG_BD_LIGHT, r, device, 2, k)

    def emit(self, r: int, device) -> torch.Tensor:
        return self._u(_TAG_BD_EMIT, r, device, 2)

    def light_point(self, which: int, area: torch.Tensor, count: int, r: int, device):
        """The pick through the area CDF of one uniform (the same
        distribution as the JAX package's Gumbel-max pick over log-areas)."""
        u = self._u(_TAG_BD_POINT, r, device, 3, which, sets=count)
        cdf = torch.cumsum(area, 0)
        idx = torch.searchsorted(cdf, (u[:, 0] * cdf[-1]).contiguous(), right=True)
        return torch.clamp(idx, max=area.shape[0] - 1), u[:, 1:]


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

    def bdpt(self, sample: int, strip: int, nstrips: int = 1) -> _HashBdptStream:
        return _HashBdptStream(self.seed, sample, strip)

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


def as_bdpt_stream(rng):
    """A bidirectional stream from `rng` for a direct call of
    ``bdpt.trace_rays``: a ``torch.Generator`` keys strip 0 of sample 0 of a
    :class:`HashDraws`; anything else is taken as a stream."""
    if isinstance(rng, torch.Generator):
        return HashDraws.from_generator(rng).bdpt(0, 0)
    return rng
