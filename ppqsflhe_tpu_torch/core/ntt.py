"""NTT basis (the 2N-th roots ψ per RNS modulus), bit reversal, and the
radix-2 negacyclic transforms.

Twin of :mod:`ppqsflhe_tpu.core.ntt`. :class:`NttBasis` holds the roots;
:class:`Radix2Ntt` holds the bit-reversed ψ tables with their Shoup
companions and runs ``_ntt_impl``/``_intt_impl``: Cooley–Tukey forward
(natural-order coefficients → bit-reversed evaluations) and Gentleman–Sande
inverse with N^{-1} folded in as a Shoup product. Each of the log2(N) stages
is one batched butterfly over a ``(..., L, m, 2, t)`` view, on whatever
device the tensor lives. The JAX package runs these transforms in XLA, with
no Pallas kernel, so plain torch is their port; it is the evaluation order
of the ``ntt_backend="radix2"`` contexts (the CLI's default).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from . import primes
from .modarith import modadd, modsub, shoup_mul, u64_to_i64


def bit_reverse_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint64)
    out = np.zeros(n, dtype=np.uint64)
    for b in range(bits):
        out |= ((idx >> np.uint64(b)) & np.uint64(1)) << np.uint64(bits - 1 - b)
    return out.astype(np.int64)


def _psi_tables(psi: int, n: int, q: int):
    """(psi_rev, psi_rev_shoup) — powers ψ^i in bit-reversed index order."""
    raw, acc = [], 1
    for _ in range(n):
        raw.append(acc)
        acc = (acc * psi) % q
    w = [raw[int(r)] for r in bit_reverse_indices(n)]
    return (np.array(w, dtype=np.uint64),
            np.array([primes.shoup_precompute(v, q) for v in w], dtype=np.uint64))


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


class Radix2Ntt:
    """The radix-2 transforms over a basis: int64[..., L, N] with
    L = len(idx) limbs of the basis. The host tables are the JAX
    ``NttBasis``'s (u64, same names); they are uploaded once per device and
    limb subset."""

    def __init__(self, basis: NttBasis):
        n, L = basis.n, len(basis.moduli)
        self.n = n
        self.psi_rev = np.zeros((L, n), np.uint64)
        self.psi_rev_shoup = np.zeros((L, n), np.uint64)
        self.ipsi_rev = np.zeros((L, n), np.uint64)
        self.ipsi_rev_shoup = np.zeros((L, n), np.uint64)
        self.ninv = np.zeros((L, 1), np.uint64)
        self.ninv_shoup = np.zeros((L, 1), np.uint64)
        for i, (q, psi) in enumerate(zip(basis.moduli, basis.psis)):
            self.psi_rev[i], self.psi_rev_shoup[i] = _psi_tables(psi, n, q)
            self.ipsi_rev[i], self.ipsi_rev_shoup[i] = _psi_tables(
                primes.mod_inverse(psi, q), n, q)
            nv = primes.mod_inverse(n, q)
            self.ninv[i, 0], self.ninv_shoup[i, 0] = nv, primes.shoup_precompute(nv, q)
        self.q_vec = np.array(basis.moduli, np.uint64).reshape(L, 1)
        self._dev: Dict[tuple, tuple] = {}

    def _tables(self, sel, device):
        key = (tuple(sel), str(device))
        t = self._dev.get(key)
        if t is None:
            t = self._dev[key] = tuple(
                torch.as_tensor(u64_to_i64(a[list(sel)]), device=device)
                for a in (self.psi_rev, self.psi_rev_shoup, self.ipsi_rev,
                          self.ipsi_rev_shoup, self.ninv, self.ninv_shoup, self.q_vec))
        return t

    def _sel(self, x, idx):
        sel = list(range(len(self.q_vec))) if idx is None else [int(i) for i in idx]
        if x.shape[-2] != len(sel) or x.shape[-1] != self.n:
            raise ValueError(f"{tuple(x.shape[-2:])} limbs x coefficients given for limb "
                             f"subset {sel} at N={self.n}")
        return sel

    def ntt(self, a: torch.Tensor, idx=None) -> torch.Tensor:
        """Natural-order coefficients → bit-reversed evaluations."""
        psi, psi_sh, *_, q_vec = self._tables(self._sel(a, idx), a.device)
        return _ntt_impl(a, psi, psi_sh, q_vec, self.n)

    def intt(self, a: torch.Tensor, idx=None) -> torch.Tensor:
        """Bit-reversed evaluations → natural-order coefficients."""
        _, _, ipsi, ipsi_sh, ninv, ninv_sh, q_vec = self._tables(self._sel(a, idx), a.device)
        return _intt_impl(a, ipsi, ipsi_sh, ninv, ninv_sh, q_vec, self.n)


def _ntt_impl(a, psi_rev, psi_rev_shoup, q_vec, n: int):
    lead, L = a.shape[:-2], a.shape[-2]
    q = q_vec.reshape(L, 1, 1, 1)
    x, m, t = a, 1, n
    while m < n:
        t //= 2
        # view (..., L, m, 2, t); this stage's twiddles are psi_rev[:, m:2m]
        x = x.reshape(lead + (L, m, 2, t))
        w = psi_rev[:, m : 2 * m].reshape(L, m, 1, 1)
        ws = psi_rev_shoup[:, m : 2 * m].reshape(L, m, 1, 1)
        u = x[..., 0:1, :]
        v = shoup_mul(x[..., 1:2, :], w, ws, q)
        x = torch.cat([modadd(u, v, q), modsub(u, v, q)], dim=-2).reshape(lead + (L, n))
        m *= 2
    return x


def _intt_impl(a, ipsi_rev, ipsi_rev_shoup, ninv, ninv_shoup, q_vec, n: int):
    lead, L = a.shape[:-2], a.shape[-2]
    q = q_vec.reshape(L, 1, 1, 1)
    x, t, m = a, 1, n
    while m > 1:
        h = m // 2
        x = x.reshape(lead + (L, h, 2, t))
        w = ipsi_rev[:, h : 2 * h].reshape(L, h, 1, 1)
        ws = ipsi_rev_shoup[:, h : 2 * h].reshape(L, h, 1, 1)
        u, v = x[..., 0:1, :], x[..., 1:2, :]
        x = torch.cat([modadd(u, v, q), shoup_mul(modsub(u, v, q), w, ws, q)],
                      dim=-2).reshape(lead + (L, n))
        t *= 2
        m = h
    return shoup_mul(x, ninv, ninv_shoup, q_vec)
