"""The four-step kernel order of the evaluation domain (host numpy only).

Twin of ``kernel_to_std`` in :mod:`ppqsflhe_tpu.ops.fourstep`. A four-step
transform of N = n1·n2 coefficients leaves evaluation k2·n1 + k1 at position
u = rev2(k2)·n1 + rev1(k1) ("kernel order"); the standard evaluation order is
bit-reversed over all of N. Rotations are defined on the standard order, so
the context corrects each Galois permutation by this map.
"""

from __future__ import annotations

import numpy as np

from ..core.ntt import bit_reverse_indices


def kernel_to_std(n: int) -> np.ndarray:
    """perm with std_eval[b] = kernel_eval[perm[b]] (int64, length n)."""
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    rev1, rev2, rev_n = (bit_reverse_indices(m) for m in (n1, n2, n))
    u = np.arange(n, dtype=np.int64).reshape(n2, n1)          # u = r2·n1 + r1
    k = rev2[:, None] * n1 + rev1[None, :]
    perm = np.zeros(n, np.int64)
    perm[rev_n[k].reshape(-1)] = u.reshape(-1)
    return perm
