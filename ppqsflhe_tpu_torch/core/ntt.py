"""NTT basis: the 2N-th roots ψ per RNS modulus, and bit reversal.

Twin of the table half of :mod:`ppqsflhe_tpu.core.ntt`. The port runs every
transform through the four-step digit-matmul NTT (:mod:`..ops.mxu_ntt` and
its CUDA kernel), which needs only the roots; the radix-2 transforms and
their bit-reversed ψ tables are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from . import primes


def bit_reverse_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint64)
    out = np.zeros(n, dtype=np.uint64)
    for b in range(bits):
        out |= ((idx >> np.uint64(b)) & np.uint64(1)) << np.uint64(bits - 1 - b)
    return out.astype(np.int64)


class NttBasis:
    """Ring dimension N over a list of RNS moduli with their 2N-th roots.

    ``psis`` may be given explicitly (to pin OpenFHE's exact roots of unity)
    or derived canonically from the minimal primitive root."""

    def __init__(self, n: int, moduli: Sequence[int], psis: Sequence[int] | None = None):
        if n & (n - 1):
            raise ValueError("N must be a power of two")
        self.n = n
        self.moduli = tuple(int(q) for q in moduli)
        if psis is None:
            psis = [primes.root_of_unity(2 * n, q) for q in self.moduli]
        self.psis = tuple(int(p) for p in psis)
        for q, psi in zip(self.moduli, self.psis):
            if not primes.is_primitive_root_of_unity(psi, 2 * n, q):
                raise ValueError(f"psi={psi} is not a primitive {2*n}-th root mod {q}")
