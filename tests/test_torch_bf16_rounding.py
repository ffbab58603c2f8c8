"""PyTorch's bfloat16 arithmetic rounds the exact result once.

The fused V-cycle's bfloat16 kernels "mg16_pre" and "mg16_restrict"
(``libfluid_tpu_torch/csrc/vcycle.cu``) use the card's bfloat16 multiply, add
and subtract, each one rounding of the exact result, where the plain stages
use PyTorch's bfloat16 ``*``, ``+`` and ``-``, which compute in float32 and
round to bfloat16. ``chip_smoke.py`` holds the card's operations to one
rounding of the float32 result over all 2^32 pairs
(``csrc/bf16_check.cu``); this file holds PyTorch's side: on a numpy-seeded
sample of pairs (uniform bit patterns, so wide exponent gaps and subnormals,
pairs of close exponents, so ties and cancellations, and the signed zeros,
subnormal and overflow edges), each result equals the exact result rounded
once to bfloat16 (to nearest, ties to even), computed with Python integers,
bit for bit: value, infinity and the sign of a zero."""

import math

import numpy as np
import pytest
import torch

from libfluid_tpu_torch import _bf16_check

torch.set_num_threads(1)

_MIN_EXP = -133  # the exponent of bfloat16's least subnormal; a result at or
# past 2^128 in magnitude, once rounded, is infinite


def _finite_bits(rng, n):
    """n bfloat16 bit patterns drawn uniformly among the finite ones."""
    bits = rng.integers(0, 1 << 16, size=2 * n, dtype=np.uint32)
    bits = bits[(bits & 0x7F80) != 0x7F80]
    return bits[:n]


def _close_pairs(rng, n):
    """Pairs whose exponents differ by at most 9: sums that tie or cancel."""
    a = _finite_bits(rng, n)
    exp_a = (a >> 7) & 0xFF
    exp_b = np.clip(exp_a.astype(np.int64) + rng.integers(-9, 10, size=n), 0, 254).astype(np.uint32)
    b = (rng.integers(0, 2, size=n, dtype=np.uint32) << 15) | (exp_b << 7) | rng.integers(0, 128, size=n,
                                                                                             dtype=np.uint32)
    return a, b


def _edges():
    """Every pair of ±0, ±(least and largest subnormal), ±(least normal),
    ±1, ±(largest finite)."""
    mags = [0x0000, 0x0001, 0x007F, 0x0080, 0x3F80, 0x7F7F]
    vals = np.array([m | s for m in mags for s in (0, 0x8000)], dtype=np.uint32)
    a, b = np.meshgrid(vals, vals, indexing="ij")
    return a.ravel(), b.ravel()


def _sample():
    rng = np.random.default_rng(14)
    a0, b0 = _finite_bits(rng, 200_000), _finite_bits(rng, 200_000)
    a1, b1 = _close_pairs(rng, 100_000)
    a2 = _finite_bits(rng, 5_000)  # x and -x, x and x
    a3, b3 = _edges()
    a = np.concatenate([a0, a1, a2, a2, a3])
    b = np.concatenate([b0, b1, a2 ^ 0x8000, a2, b3])
    return a.astype(np.uint16), b.astype(np.uint16)


def _parts(bits):
    """(sign, integer m, exponent e) with |value| = m * 2^e exactly."""
    sign = -1 if bits & 0x8000 else 1
    e, f = (bits >> 7) & 0xFF, bits & 0x7F
    if e == 0:
        return sign, f, _MIN_EXP
    return sign, f | 0x80, e - 127 - 7


def _round_once(n, e, zero_sign):
    """The bfloat16 value nearest to n * 2^e (n a Python integer), ties to
    even, as a float; `zero_sign` is the sign an exact zero takes."""
    if n == 0:
        return math.copysign(0.0, zero_sign)
    sign, n = (-1.0 if n < 0 else 1.0), abs(n)
    top = e + n.bit_length() - 1  # the exponent of the leading bit
    low = max(top - 7, _MIN_EXP)  # the exponent of the last bit kept
    if low > e:
        shift = low - e
        q, rem = n >> shift, n & ((1 << shift) - 1)
        half = 1 << (shift - 1)
        if rem > half or (rem == half and q & 1):
            q += 1
        n, e = q, low
    if n.bit_length() + e > 128:  # n * 2^e >= 2^128
        return sign * math.inf
    return sign * math.ldexp(n, e)


def _exact(op, a_bits, b_bits):
    sa, ma, ea = _parts(int(a_bits))
    sb, mb, eb = _parts(int(b_bits))
    if op == "mul":
        # the sign of a zero product is the sign of the product
        return _round_once(sa * ma * sb * mb, ea + eb, sa * sb)
    if op == "sub":
        sb = -sb
    e = min(ea, eb)
    n = sa * (ma << (ea - e)) + sb * (mb << (eb - e))
    # an exact zero sum is +0, unless both terms are -0
    both_neg_zero = ma == 0 and mb == 0 and sa < 0 and sb < 0
    return _round_once(n, e, -1 if both_neg_zero else 1)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_bfloat16_ops_round_the_exact_result_once(op):
    a_bits, b_bits = _sample()
    a = torch.from_numpy(a_bits.view(np.int16)).view(torch.bfloat16)
    b = torch.from_numpy(b_bits.view(np.int16)).view(torch.bfloat16)
    got = {"add": a + b, "sub": a - b, "mul": a * b}[op]
    assert got.dtype == torch.bfloat16
    got = got.double().numpy()  # bfloat16 -> float64 is exact
    want = np.array([_exact(op, x, y) for x, y in zip(a_bits, b_bits)])
    assert not np.isnan(got).any()
    same = (got == want) & (np.signbit(got) == np.signbit(want))
    assert same.all(), (op, [(hex(a_bits[i]), hex(b_bits[i]), got[i], want[i])
                             for i in np.flatnonzero(~same)[:5]])
    # the sample reaches the cases the argument turns on
    assert (want == 0).sum() > 100 and np.isinf(want).sum() > 10
    assert (np.abs(want[want != 0]) < 2.0 ** -126).sum() > 100  # subnormal results


def test_the_card_check_needs_a_card():
    """The card's side of the argument (``_bf16_check.rounding_check``)
    runs on a CUDA device only; the operations the kernels use are among
    those it counts."""
    assert set(_bf16_check.KERNEL_OPS) <= set(_bf16_check.CHECK_OPS)
    with pytest.raises(RuntimeError, match="CUDA device"):
        _bf16_check.rounding_check("cpu")
