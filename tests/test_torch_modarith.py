"""The port's int64 modular arithmetic against Python ints and the JAX package.

Every comparison is bit-exact. Moduli: 60-, 40- and 20-bit NTT primes;
operands include 0, 1 and q−1, and Shoup companions ≥ 2^63 (negative as
int64) are exercised explicitly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppqsflhe_tpu.core import modarith as jm
from ppqsflhe_tpu.core import primes as jprimes
from ppqsflhe_tpu_torch.core import modarith as tm
from ppqsflhe_tpu_torch.core import primes

MODULI = [primes.first_prime_down(60, 1 << 15), primes.first_prime_down(40, 1 << 15),
          primes.first_prime_down(20, 1 << 15)]


def _operands(q, size=512, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, q, size, dtype=np.uint64)
    b = rng.integers(0, q, size, dtype=np.uint64)
    edge = np.array([0, 1, q - 1, q - 2, q // 2], np.uint64)
    a[: len(edge)] = edge
    b[: len(edge)] = edge[::-1]
    return a, b


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint64).view(np.int64).copy())


def _u(t):
    return t.numpy().view(np.uint64)


def _ints(a):
    return [int(v) for v in a]


def test_primes_copy_matches_reference():
    """The copied primes module gives the JAX package's chains and roots."""
    m = 1 << 15
    assert primes.prime_chain(40, 3, m) == jprimes.prime_chain(40, 3, m)
    assert primes.first_prime_down(60, m) == jprimes.first_prime_down(60, m)
    for q in MODULI:
        assert primes.root_of_unity(m, q) == jprimes.root_of_unity(m, q)
        assert primes.mont_qinv_neg(q) == jprimes.mont_qinv_neg(q)


@pytest.mark.parametrize("q", MODULI, ids=["q60", "q40", "q20"])
def test_modops_match_python_ints(q):
    a, b = _operands(q)
    ta, tb, tq = _t(a), _t(b), torch.tensor(q)
    qinv = int(_t([primes.mont_qinv_neg(q)])[0])
    r2 = primes.mont_r2(q)
    R_inv = pow(1 << 64, -1, q)
    A, Bv = _ints(a), _ints(b)
    assert _ints(_u(tm.modadd(ta, tb, tq))) == [(x + y) % q for x, y in zip(A, Bv)]
    assert _ints(_u(tm.modsub(ta, tb, tq))) == [(x - y) % q for x, y in zip(A, Bv)]
    assert _ints(_u(tm.modneg(ta, tq))) == [(-x) % q for x in A]
    assert _ints(_u(tm.mont_mul(ta, tb, tq, qinv))) == [x * y * R_inv % q for x, y in zip(A, Bv)]
    assert _ints(_u(tm.modmul(ta, tb, tq, qinv, r2))) == [x * y % q for x, y in zip(A, Bv)]
    w = int(b[7])
    ws = primes.shoup_precompute(w, q)
    tw, tws = torch.tensor(w), _t([ws])[0]
    assert _ints(_u(tm.shoup_mul(ta, tw, tws, tq))) == [x * w % q for x in A]
    # wide: unreduced operands up to 2^62
    wide = np.random.default_rng(1).integers(0, 1 << 62, 512, dtype=np.uint64)
    got = _ints(_u(tm.shoup_mul_wide(_t(wide), tw, tws, tq)))
    assert got == [x * w % q for x in _ints(wide)]
    # lazy: operands < 4q give a result in [0, 2q) congruent to a·w
    lazy = _ints(_u(tm.shoup_mul_lazy(_t(a + np.uint64(3 * q)), tw, tws, tq)))
    assert all(v < 2 * q and v % q == x * w % q for v, x in zip(lazy, A))


@pytest.mark.parametrize("q", MODULI, ids=["q60", "q40", "q20"])
def test_modops_match_jax(q):
    a, b = _operands(q, seed=2)
    ta, tb, tq = _t(a), _t(b), torch.tensor(q)
    ja, jb, jq = jnp.asarray(a), jnp.asarray(b), jnp.uint64(q)
    qinv_u = primes.mont_qinv_neg(q)
    qinv = int(_t([qinv_u])[0])
    r2 = primes.mont_r2(q)
    w = q - 1                                   # companion ≥ 2^63: negative int64
    ws = primes.shoup_precompute(w, q)
    assert ws >= 1 << 63
    tw, tws = torch.tensor(w), _t([ws])[0]
    jw, jws = jnp.uint64(w), jnp.uint64(ws)
    pairs = [
        (tm.modadd(ta, tb, tq), jm.modadd(ja, jb, jq)),
        (tm.modsub(ta, tb, tq), jm.modsub(ja, jb, jq)),
        (tm.modneg(ta, tq), jm.modneg(ja, jq)),
        (tm.mont_mul(ta, tb, tq, qinv), jm.mont_mul(ja, jb, jq, jnp.uint64(qinv_u))),
        (tm.modmul(ta, tb, tq, qinv, r2),
         jm.modmul(ja, jb, jq, jnp.uint64(qinv_u), jnp.uint64(r2))),
        (tm.shoup_mul(ta, tw, tws, tq), jm.shoup_mul(ja, jw, jws, jq)),
        (tm.shoup_mul_wide(ta << 2, tw, tws, tq), jm.shoup_mul_wide(ja << 2, jw, jws, jq)),
        (tm.mul_hi(ta, tws), jm.mul_hi(ja, jws)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(_u(got), np.asarray(want))


def test_mul_hi_full_64bit_range():
    """High half of the unsigned product for operands anywhere in [0, 2^64),
    i.e. int64 bit patterns of either sign."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << 64, 1024, dtype=np.uint64, endpoint=False)
    b = rng.integers(0, 1 << 64, 1024, dtype=np.uint64, endpoint=False)
    a[:4] = [0, 1, (1 << 64) - 1, 1 << 63]
    b[:4] = [(1 << 64) - 1, (1 << 64) - 1, (1 << 64) - 1, 1 << 63]
    got = _ints(_u(tm.mul_hi(_t(a), _t(b))))
    assert got == [(x * y) >> 64 for x, y in zip(_ints(a), _ints(b))]


def test_u64_to_i64_keeps_bits():
    vals = [0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]
    got = tm.u64_to_i64(vals)
    assert got.dtype == np.int64
    assert [int(v) for v in got.view(np.uint64)] == vals
