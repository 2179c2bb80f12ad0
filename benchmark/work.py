"""The work one round needs, from the published algorithm and the cell's
shapes, whatever kernels do it: the yardstick of the byte rooflines.

A round of C clients (the hub last), B ciphertexts a client: C−1 inbound
proxy re-encryptions (PRE) into the hub's domain at level l_in, the sum and
÷C, then C−1 outbound PREs of the average at level l_out; OpenFHE's round
(lazy 0) rescales the sum once (2B polys at full level L). L counts every
ciphertext modulus, a FLEXIBLEAUTOEXT extension prime with them (lazy-4's
first LevelReduce drops it). A PRE is one
hybrid key switch of B polys at level l with K special primes and digits of
α limbs: ModUp (inverse transform of l limbs; per active digit of d limbs a
base extension d → l+K−d and a forward transform of those), the inner
product with the rekey over l+K limbs, ModDown of both components (inverse
transform of K limbs, base extension K → l, forward transform of l limbs).
Counts are in limb-polys of N coefficients, 8 bytes each."""

from __future__ import annotations

from dataclasses import dataclass

LAZY, FULL = 4, 0


@dataclass(frozen=True)
class Round:
    n: int
    L: int           # ciphertext moduli at full level
    K: int           # special primes
    alpha: int       # limbs per key-switching digit
    clients: int
    batch: int
    lazy: int

    @property
    def l_in(self) -> int:
        return self.L - 1 if self.lazy == LAZY else self.L

    @property
    def l_out(self) -> int:
        return self.L - 2 if self.lazy == LAZY else self.L - 1

    @property
    def rescale(self) -> bool:
        return self.lazy == FULL

    @property
    def poly_bytes(self) -> int:
        return self.n * 8

    def digits(self, l: int) -> list:
        """Limbs of each digit active at level l."""
        return [min(self.alpha, l - g) for g in range(0, l, self.alpha)]

    def hops(self) -> list:
        """(level, how many PREs) of the round's key switches."""
        return [(self.l_in, self.clients - 1), (self.l_out, self.clients - 1)]


def of(chain, clients: int, batch: int, lazy: int) -> Round:
    if lazy not in (LAZY, FULL):
        raise ValueError(f"no work plan for lazy={lazy}")
    return Round(chain.n, len(chain.q), len(chain.p), chain.alpha, clients, batch, lazy)
