"""The RNS moduli chain and the 2N-th roots, worked out from a deployment's
published parameters (OpenFHE's rule, as the upstream ``config_cc.json``
sets it: a first modulus of ``first_mod_size`` bits, ``multiplicative_depth``
scaling primes of ``scaling_mod_size`` bits, each the next prime ≡ 1 mod 2N
below 2^bits, under FLEXIBLEAUTOEXT an extension prime of ``extra_mod_size``
bits, the first prime ≡ 1 mod 2N from 2^(bits−1) up (557057 for 20 bits at
N = 2^14, upstream's q3), and enough 60-bit special primes to cover the
largest of the ``dnum`` key-switching digits), and the order in which a
ring's evaluations are laid out in memory."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)   # exact below 3.3e24


def is_prime(n: int) -> bool:
    """Miller–Rabin with the first twelve primes as witnesses: exact for
    every n below 3.3·10^24, far above any modulus here."""
    if n < 2:
        return False
    for p in _WITNESSES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d, r = d // 2, r + 1
    for a in _WITNESSES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def primes_below(bits: int, m: int, count: int, avoid=()) -> list:
    """The ``count`` largest primes below 2^bits that are ≡ 1 mod m, not in
    ``avoid``, in descending order."""
    out, p = [], (1 << bits) + 1 - m
    while len(out) < count:
        if p <= m:
            raise ValueError(f"too few primes ≡ 1 mod {m} below 2^{bits}")
        if p not in avoid and is_prime(p):
            out.append(p)
        p -= m
    return out


@dataclass(frozen=True)
class Chain:
    n: int
    q: tuple          # ciphertext moduli q0 … qL−1
    p: tuple          # special primes
    dnum: int
    ext: bool = False     # the last of ``q`` is a FLEXIBLEAUTOEXT extension prime

    @property
    def alpha(self) -> int:
        """Limbs per key-switching digit."""
        return -(-len(self.q) // self.dnum)


def prime_from(bits: int, m: int) -> int:
    """The first prime ≡ 1 mod m from 2^(bits−1) up."""
    p = (1 << (bits - 1)) + 1
    p += (-(p - 1)) % m
    while not is_prime(p):
        p += m
    return p


def chain(n: int, depth: int, first_bits: int, scale_bits: int, dnum: int,
          ext_bits: int = 0) -> Chain:
    m = 2 * n
    q = primes_below(first_bits, m, 1)
    q += primes_below(scale_bits, m, depth, avoid=set(q))
    if ext_bits:
        q.append(prime_from(ext_bits, m))
    alpha = -(-len(q) // dnum)
    digit_bits = max(sum(x.bit_length() for x in q[i:i + alpha]) for i in range(0, len(q), alpha))
    p = primes_below(60, m, -(-digit_bits // 60), avoid=set(q))
    return Chain(n, tuple(q), tuple(p), dnum, bool(ext_bits))


def of(cfg: dict) -> Chain:
    """The chain a configuration file states."""
    return chain(cfg["ring_dim"], cfg["multiplicative_depth"], cfg["first_mod_size"],
                 cfg["scaling_mod_size"], cfg["dnum"], cfg.get("extra_mod_size", 0))


def min_root(order: int, q: int) -> int:
    """The smallest primitive ``order``-th root of unity mod q (order a
    power of two): OpenFHE's choice of ψ. A primitive root is w = x^((q−1)/order)
    with w^(order/2) ≡ −1; every other one is an odd power of it."""
    if (q - 1) % order:
        raise ValueError(f"{order} does not divide {q} − 1")
    x = 2
    while pow(x, (q - 1) // 2, q) != q - 1:      # a quadratic non-residue
        x += 1
    w = pow(x, (q - 1) // order, q)
    w2, cur, best = w * w % q, w, w
    for _ in range(order // 2 - 1):
        cur = cur * w2 % q
        best = min(best, cur)
    return best


def _bitrev(m: int) -> np.ndarray:
    bits = m.bit_length() - 1
    idx = np.arange(m)
    return np.array([int(format(i, f"0{bits}b")[::-1], 2) if bits else 0 for i in idx])


def eval_index(n: int, order: str) -> np.ndarray:
    """k[u] for each memory position u: position u holds the evaluation at
    ψ^(2k[u]+1). ``"fourstep"``: with n1 = 2^⌊log2(N)/2⌋, n2 = N/n1, the
    evaluation k2·n1 + k1 lies at u = rev(k2)·n1 + rev(k1) (bit reversal
    over log2 n2 and log2 n1 bits). ``"radix2"``: evaluation k lies at the
    bit reversal of k over log2 N bits."""
    if order == "radix2":
        return _bitrev(n)
    if order != "fourstep":
        raise ValueError(f"unknown evaluation order {order!r}")
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    r2, r1 = np.divmod(np.arange(n), n1)
    return _bitrev(n2)[r2] * n1 + _bitrev(n1)[r1]
