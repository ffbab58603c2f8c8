"""Deterministic coincident-pair jitter for the position-correction springs
(port of ``libfluid_tpu.sim.jitterhash``, bit for bit).

The jitter is a counter-based hash of ``(substep seed, global cell
coordinates, slot rank, component)``: int32 wraparound multiplies, xors and
LOGICAL right shifts. ``torch``'s ``>>`` on int32 is arithmetic, so every
shift masks off the sign bits it drags in. Kernel E (``csrc/correction.cu``)
evaluates the same hash in uint32 arithmetic.
"""

from __future__ import annotations

import torch

from portbench.reference.lf.config import resolve_device

# lowbias32 constants as int32 (two's-complement wraparound gives the bits
# of the uint32 original)
_M1 = 0x7FEB352D
_M2 = 0x846CA68B - (1 << 32)

# distinct odd mixing constants for the coordinate linear combination
_CX = 198491317
_CY = 6542989
_CZ = 362437
_CK = 87178291
_CC = 1299709

_SCALE = 1.0 / 2147483648.0  # 2^-31


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of an int32 tensor."""
    return (x >> s) & ((1 << (32 - s)) - 1)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ _srl(x, 16)
    x = x * _M1
    x = x ^ _srl(x, 15)
    x = x * _M2
    x = x ^ _srl(x, 16)
    return x


def jitter_bits(seed, gx, gy, gz, slot, comp) -> torch.Tensor:
    """int32 hash of (seed, global cell, slot, component); int32 tensors
    that broadcast."""
    t = gx * _CX + gy * _CY + gz * _CZ + slot * _CK + comp * _CC
    return _mix32(_mix32(t ^ seed))


def jitter_value(seed, gx, gy, gz, slot, comp) -> torch.Tensor:
    """Uniform jitter in (-1, 1): the hash bits scaled by 2^-31."""
    return jitter_bits(seed, gx, gy, gz, slot, comp).to(torch.float32) * _SCALE


def jitter_field(seed, kc: int, shape, origin, dtype, device=None) -> torch.Tensor:
    """(3, kc, nx, ny, nz) jitter field over a local grid window whose cell
    (0, 0, 0) has global coordinates ``origin``, on `device` (None: the CUDA
    card)."""
    device = resolve_device(device)
    nx, ny, nz = shape
    ox, oy, oz = origin

    def ar(n, o):
        return torch.arange(n, dtype=torch.int32, device=device) + o

    gx = ar(nx, ox)[None, None, :, None, None]
    gy = ar(ny, oy)[None, None, None, :, None]
    gz = ar(nz, oz)[None, None, None, None, :]
    slot = ar(kc, 0)[None, :, None, None, None]
    comp = ar(3, 0)[:, None, None, None, None]
    seed = torch.tensor(seed, dtype=torch.int32, device=device)
    return jitter_value(seed, gx, gy, gz, slot, comp).to(dtype)


def seed_from_key(generator: torch.Generator) -> int:
    """The per-substep jitter seed, drawn from a CPU generator (the
    counterpart of JAX's ``randint(key, (), 0, 2**31 - 1)``; the two draw
    different numbers). A CPU draw costs no device sync."""
    return int(torch.randint(0, 2**31 - 1, (), generator=generator))
