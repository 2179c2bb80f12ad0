"""64-bit modular arithmetic on ``torch.int64`` lanes.

Twin of :mod:`ppqsflhe_tpu.core.modarith`. Residues are int64 with values
< 2^62 (every modulus is < 2^60), so ordinary signed compares and adds are
exact on them. Full 64-bit constants (Shoup companions ⌊w·2^64/q⌋ and
-q^{-1} mod 2^64) may exceed 2^63 and are carried as their two's-complement
bit pattern: int64 multiplication wraps mod 2^64, which is exactly the
unsigned low product, and the high half of a product is built from 32-bit
halves with *logical* right shifts (arithmetic shift, then mask).

These are the plain versions: elementwise torch ops that run on any device.
The CUDA kernels (``ops/``, ``csrc/``) use native ``uint64_t`` and
``__umul64hi`` and must give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
INT64_MIN = -(1 << 63)


def u64_to_i64(vals) -> np.ndarray:
    """Python ints / numpy uint64 in [0, 2^64) → int64 numpy (same bits)."""
    return np.asarray(vals, dtype=np.uint64).view(np.int64)


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of the 64-bit pattern by 0 < s < 64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mul128(a, b):
    """Full 64x64 → 128-bit unsigned product as (hi, lo) int64 bit patterns."""
    a_lo = a & _M32
    a_hi = _srl(a, 32)
    b_lo = b & _M32
    b_hi = _srl(b, 32)
    ll = a_lo * b_lo            # each partial product wraps mod 2^64: the bits
    lh = a_lo * b_hi            # are the unsigned product's
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = _srl(ll, 32) + (lh & _M32) + (hl & _M32)  # <= 3*(2^32-1)
    lo = (mid << 32) | (ll & _M32)
    hi = hh + _srl(lh, 32) + _srl(hl, 32) + _srl(mid, 32)
    return hi, lo


def mul_hi(a, b):
    """High 64 bits of the unsigned 128-bit product."""
    return _mul128(a, b)[0]


def modadd(a, b, q):
    s = a + b
    return torch.where(s >= q, s - q, s)


def modsub(a, b, q):
    return torch.where(a >= b, a - b, a + q - b)


def modneg(a, q):
    return torch.where(a == 0, a, q - a)


def mont_mul_lazy(a, b, q, qinv_neg):
    """Montgomery product a*b*2^-64 mod q without the final subtract, in
    [0, 2q) for a < 4q, b < q (twin of ``u32pair.mont_mul64_lazy``).
    ``qinv_neg`` = -q^{-1} mod 2^64 as an int64 bit pattern."""
    t_hi, t_lo = _mul128(a, b)
    m = t_lo * qinv_neg
    return t_hi + mul_hi(m, q) + (t_lo != 0).to(torch.int64)


def mont_mul(a, b, q, qinv_neg):
    """Montgomery product a*b*2^-64 mod q, inputs reduced mod q.
    ``qinv_neg`` = -q^{-1} mod 2^64 as an int64 bit pattern."""
    u = mont_mul_lazy(a, b, q, qinv_neg)
    return torch.where(u >= q, u - q, u)


def modmul(a, b, q, qinv_neg, r2):
    """Exact a*b mod q via two Montgomery products (r2 = 2^128 mod q)."""
    return mont_mul(mont_mul(a, r2, q, qinv_neg), b, q, qinv_neg)


def shoup_mul(a, w, w_shoup, q):
    """a*w mod q for a constant w with Shoup companion ⌊w·2^64/q⌋; a < q."""
    r = a * w - mul_hi(a, w_shoup) * q     # wraps to the true value in [0, 2q)
    return torch.where(r >= q, r - q, r)


def shoup_mul_lazy(a, w, w_shoup, q):
    """Harvey's lazy Shoup product: a < 4q → a*w mod q in [0, 2q)."""
    return a * w - mul_hi(a, w_shoup) * q


def shoup_mul_wide(a, w, w_shoup, q):
    """a*w mod q for UNREDUCED a < 2^62: r < 3q, two conditional subtracts."""
    r = a * w - mul_hi(a, w_shoup) * q
    r = torch.where(r >= q + q, r - q - q, r)
    return torch.where(r >= q, r - q, r)
