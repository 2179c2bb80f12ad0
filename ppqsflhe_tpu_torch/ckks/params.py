"""CKKS-RNS parameters and crypto context.

Twin of :mod:`ppqsflhe_tpu.ckks.params`. The context owns the RNS chains
(ciphertext chain Q = [q0..qL], special primes P for hybrid key switching),
the four-step NTT runner over the QP basis (``ntt_impl``: the digit-matmul
route or the butterfly transform), the digit partition, the Galois
permutations in its evaluation order, and lazily cached per-level
constants. Constants are host Python
ints / numpy; :meth:`CkksContext.consts` hands them out as int64 tensors on
the device asked for, uploaded once per device.

The port's evaluation domain is the four-step kernel order — the JAX
package's ``ntt_backend="fourstep"`` — on every device. Which implementation
runs a transform follows the tensor: the plain torch version on the CPU, the
CUDA kernels on the card (the JAX package's ``use_pallas_ks`` gate).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..core import primes
from ..core.modarith import u64_to_i64
from ..core.ntt import NttBasis
from ..core.rns import BaseExtender
from ..ops import cuda_ntt


@dataclass(frozen=True)
class CkksParams:
    """Static scheme parameters."""

    n: int = 1 << 14                  # ring dimension (reference: 16384)
    q_moduli: Tuple[int, ...] = ()    # ciphertext modulus chain [q0..qL]
    p_moduli: Tuple[int, ...] = ()    # special primes for hybrid keyswitch
    q_roots: Tuple[int, ...] | None = None   # optional pinned 2N-th roots (Q)
    p_roots: Tuple[int, ...] | None = None
    scale_bits: int = 40              # Δ = 2^scale_bits (reference: 40)
    dnum: int = 2                     # hybrid KS digit count (reference: 2)
    slots: int = 0                    # batch size; 0 → N/2
    sigma: float = 3.19
    # the four-step NTT's implementation, by the JAX name of its counterpart:
    # "pallas_mxu" (digit-matmul route: kernels 1, 1b, 4, 5) or "pallas"
    # (butterfly: kernel 6); both give the same evaluations, bit for bit
    ntt_impl: str = cuda_ntt.MXU

    @staticmethod
    def generate(n: int = 1 << 14, mult_depth: int = 2, scale_bits: int = 40,
                 first_mod_bits: int = 60, dnum: int = 2, slots: int = 0,
                 ntt_impl: str = cuda_ntt.MXU) -> "CkksParams":
        """A fresh NTT-friendly chain, OpenFHE-style: one first modulus of
        ``first_mod_bits``, ``mult_depth`` scaling primes of ``scale_bits``,
        and enough 60-bit special primes to cover the largest KS digit —
        the same primes as ``ppqsflhe_tpu``'s ``CkksParams.generate``."""
        m = 2 * n
        q = [primes.first_prime_down(first_mod_bits, m)]
        q += primes.prime_chain(scale_bits, mult_depth, m, avoid=set(q))
        alpha = -(-len(q) // dnum)
        digit_bits = max(
            sum(int(x).bit_length() for x in q[i * alpha : (i + 1) * alpha])
            for i in range(dnum)
        )
        n_special = max(1, -(-digit_bits // 60))
        p = primes.prime_chain(60, n_special, m, avoid=set(q))
        return CkksParams(n=n, q_moduli=tuple(q), p_moduli=tuple(p),
                          scale_bits=scale_bits, dnum=dnum, slots=slots or n // 2,
                          ntt_impl=ntt_impl)

    @property
    def num_q(self) -> int:
        return len(self.q_moduli)

    @property
    def num_p(self) -> int:
        return len(self.p_moduli)

    @property
    def scale(self) -> float:
        return float(2 ** self.scale_bits)


class CkksContext:
    """Derived tables + lazily cached per-level precomputes."""

    def __init__(self, params: CkksParams):
        self.params = params
        self.moduli_qp = tuple(params.q_moduli) + tuple(params.p_moduli)
        roots = None
        if params.q_roots is not None:
            p_roots = params.p_roots or tuple(
                primes.root_of_unity(2 * params.n, p) for p in params.p_moduli)
            roots = tuple(params.q_roots) + p_roots
        self.basis = NttBasis(params.n, self.moduli_qp, roots)
        self.fntt = cuda_ntt.four_step_ntt(params.n, self.moduli_qp, self.basis.psis,
                                           params.ntt_impl)
        self._dev: Dict[tuple, torch.Tensor] = {}
        self._ext_cache: Dict[tuple, BaseExtender] = {}

        # Digit partition of Q limb indices for hybrid KS (fixed at keygen).
        L = params.num_q
        alpha = -(-L // params.dnum)
        self.digit_groups: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(range(i * alpha, min((i + 1) * alpha, L)))
            for i in range(params.dnum)
            if i * alpha < L
        )

    # -- constants on a device ----------------------------------------------

    def consts(self, key, values, device) -> torch.Tensor:
        """A column (len, 1) of 64-bit constants as int64 on ``device``,
        cached under ``key``; ``values`` is a callable giving Python ints."""
        k = (key, str(device))
        t = self._dev.get(k)
        if t is None:
            t = self._dev[k] = torch.as_tensor(
                u64_to_i64(list(values())), device=device).reshape(-1, 1)
        return t

    # -- limb index helpers -------------------------------------------------

    def q_idx(self, nlimbs: int) -> Tuple[int, ...]:
        return tuple(range(nlimbs))

    def p_idx(self) -> Tuple[int, ...]:
        L = self.params.num_q
        return tuple(range(L, L + self.params.num_p))

    def limb_consts(self, idx: Sequence[int], device):
        """(q, -q^{-1} mod 2^64, 2^128 mod q) for limbs ``idx``, each (l, 1)."""
        idx = tuple(idx)
        qs = [self.moduli_qp[i] for i in idx]
        return (self.consts(("q", idx), lambda: qs, device),
                self.consts(("qinv", idx), lambda: map(primes.mont_qinv_neg, qs), device),
                self.consts(("r2", idx), lambda: map(primes.mont_r2, qs), device))

    # -- NTT on limb subsets ------------------------------------------------

    def ntt(self, a: torch.Tensor, idx: Sequence[int]) -> torch.Tensor:
        return self.fntt.ntt(a, idx=tuple(idx))

    def intt(self, a: torch.Tensor, idx: Sequence[int]) -> torch.Tensor:
        return self.fntt.intt(a, idx=tuple(idx))

    def galois_perm(self, g: int, device="cuda") -> torch.Tensor:
        """Eval-order permutation for the automorphism X→X^g, corrected for
        the four-step kernel order (new[i] = old[perm[i]]), as a long tensor
        on ``device``; cached per g and device."""
        k = (("galois", g), str(device))
        if k not in self._dev:
            from .eval import _galois_perm

            P = _galois_perm(self.params.n, g)
            T = self.fntt.perm_to_std
            self._dev[k] = torch.as_tensor(T[P[np.argsort(T)]], device=device)
        return self._dev[k]

    # -- cached precomputes --------------------------------------------------

    def extender(self, src_idx: Tuple[int, ...], dst_idx: Tuple[int, ...]) -> BaseExtender:
        key = (tuple(src_idx), tuple(dst_idx))
        if key not in self._ext_cache:
            self._ext_cache[key] = BaseExtender([self.moduli_qp[i] for i in src_idx],
                                                [self.moduli_qp[i] for i in dst_idx])
        return self._ext_cache[key]

    def rescale_consts(self, nlimbs: int, device):
        """For dropping limb nlimbs-1: per remaining limb i, [q_l^{-1}]_{q_i}
        with its Shoup companion, and [q_l]_{q_i}."""
        ql = self.moduli_qp[nlimbs - 1]
        rem = [self.moduli_qp[i] for i in range(nlimbs - 1)]
        inv = [primes.mod_inverse(ql % q, q) for q in rem]
        return (self.consts(("qlinv", nlimbs), lambda: inv, device),
                self.consts(("qlinv_sh", nlimbs), lambda: (
                    primes.shoup_precompute(v, q) for v, q in zip(inv, rem)), device),
                self.consts(("ql_mod", nlimbs), lambda: (ql % q for q in rem), device))

    def moddown_consts(self, nlimbs: int, device):
        """[P^{-1}]_{q_i} (+ Shoup) over the first nlimbs Q limbs."""
        P = functools.reduce(lambda a, b: a * b, self.params.p_moduli, 1)
        qs = [self.moduli_qp[i] for i in range(nlimbs)]
        inv = [primes.mod_inverse(P % q, q) for q in qs]
        return (self.consts(("pinv", nlimbs), lambda: inv, device),
                self.consts(("pinv_sh", nlimbs), lambda: (
                    primes.shoup_precompute(v, q) for v, q in zip(inv, qs)), device))
