"""Host-side exact integer number theory for parameter generation.

A copy of :mod:`ppqsflhe_tpu.core.primes` (which is JAX-free, but its
package's ``__init__`` imports JAX). Everything here runs in Python big-int
arithmetic at context-construction time. It produces the NTT-friendly RNS
prime chains, primitive 2N-th roots of unity and the Montgomery/Shoup
precomputed constants consumed by :mod:`ppqsflhe_tpu_torch.core.modarith`
and the NTT tables.

Reference parity: OpenFHE's DCRTPoly parameter generation picks primes
q ≡ 1 (mod 2N) so the negacyclic NTT exists (see SURVEY.md §2.3 — the
checked-in context uses q0=1152921504606748673 (60-bit), two 40-bit primes and
a 20-bit FLEXIBLEAUTOEXT extra prime, all ≡ 1 mod 32768).
"""

from __future__ import annotations

import random
from typing import List


def is_prime(n: int, rounds: int = 40) -> bool:
    """Deterministic-enough Miller-Rabin for < 2^64 plus random rounds above."""
    if n < 2:
        return False
    small = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37]
    for p in small:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    # These witnesses are provably sufficient for n < 3.3e24.
    witnesses = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37]
    if n >= 3317044064679887385961981:
        rng = random.Random(0xC0FFEE ^ n)
        witnesses = [rng.randrange(2, n - 1) for _ in range(rounds)]
    for a in witnesses:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


def first_prime_down(bits: int, m: int) -> int:
    """Largest prime p < 2^bits with p ≡ 1 (mod m)."""
    p = (1 << bits) - ((1 << bits) - 1) % m  # largest value ≡ 1 mod m below 2^bits
    while p > m:
        if is_prime(p):
            return p
        p -= m
    raise ValueError(f"no prime ≡ 1 mod {m} below 2^{bits}")


def next_prime_up(start: int, m: int) -> int:
    """Smallest prime p >= start with p ≡ 1 (mod m)."""
    p = start + ((1 - start) % m)
    if p < start:
        p += m
    while True:
        if is_prime(p):
            return p
        p += m


def prime_chain(bits: int, count: int, m: int, avoid: set | None = None) -> List[int]:
    """`count` distinct primes just below 2^bits, all ≡ 1 (mod m)."""
    avoid = set(avoid or ())
    out: List[int] = []
    p = (1 << bits) + 1
    while len(out) < count:
        p = p - m
        if p <= m:
            raise ValueError("ran out of candidates")
        if p in avoid:
            continue
        if is_prime(p):
            out.append(p)
    return out


def primitive_root(q: int) -> int:
    """Smallest primitive root mod prime q."""
    phi = q - 1
    factors = _factorize(phi)
    for g in range(2, q):
        if all(pow(g, phi // f, q) != 1 for f in factors):
            return g
    raise ValueError("no primitive root found")


def _factorize(n: int) -> List[int]:
    out = []
    d = 2
    while d * d <= n:
        if n % d == 0:
            out.append(d)
            while n % d == 0:
                n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        out.append(n)
    return out


def root_of_unity(order: int, q: int) -> int:
    """The *minimum* primitive `order`-th root of unity mod q.

    This is OpenFHE's RootOfUnity<>() convention — verified bit-exact against
    the checked-in key artifacts for all four reference moduli (q=557057 →
    19, q0=1152921504606748673 → 62213374832584; SURVEY.md §2.3,
    tests/test_modarith.py). The minimum is found by enumerating all
    φ(order) primitive roots w^k (k odd for power-of-two order) via repeated
    multiplication by w².
    """
    if (q - 1) % order != 0:
        raise ValueError(f"{order} does not divide q-1")
    g = primitive_root(q)
    w = pow(g, (q - 1) // order, q)
    if order & (order - 1) == 0:
        w2 = (w * w) % q
        best = w
        cur = w
        for _ in range(order // 2 - 1):
            cur = (cur * w2) % q
            if cur < best:
                best = cur
        return best
    # general order: scan all k coprime to order
    best = None
    cur = 1
    for k in range(1, order):
        cur = (cur * w) % q
        if _gcd(k, order) == 1 and (best is None or cur < best):
            best = cur
    return best


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def is_primitive_root_of_unity(w: int, order: int, q: int) -> bool:
    if pow(w, order, q) != 1:
        return False
    for f in _factorize(order):
        if pow(w, order // f, q) == 1:
            return False
    return True


def mod_inverse(a: int, q: int) -> int:
    return pow(a, -1, q)


def mont_qinv_neg(q: int) -> int:
    """-q^{-1} mod 2^64 (the Montgomery n' constant for R = 2^64)."""
    return (-pow(q, -1, 1 << 64)) % (1 << 64)


def mont_r2(q: int) -> int:
    """R^2 mod q for R = 2^64."""
    return pow(1 << 64, 2, q)


def shoup_precompute(w: int, q: int) -> int:
    """floor(w * 2^64 / q) — Shoup companion constant for multiplying by w."""
    return (w << 64) // q
