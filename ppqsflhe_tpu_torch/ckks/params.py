"""CKKS-RNS parameters and crypto context.

Twin of :mod:`ppqsflhe_tpu.ckks.params`. The context owns the RNS chains
(ciphertext chain Q = [q0..qL], special primes P for hybrid key switching),
the NTT runner over the QP basis, the digit partition, the Galois
permutations in its evaluation order, and lazily cached per-level
constants. Constants are host Python ints / numpy;
:meth:`CkksContext.consts` hands them out as int64 tensors on the device
asked for, uploaded once per device.

``ntt_backend`` fixes the evaluation order, as in the JAX package:
``"fourstep"`` (the four-step kernel order; ``ntt_impl`` picks the
digit-matmul route or the butterfly transform) or ``"radix2"`` (the
bit-reversed order of :class:`..core.ntt.Radix2Ntt`; ``ntt_impl`` is not
read). Which implementation runs a four-step transform follows the tensor:
the plain torch version on the CPU, the CUDA kernels on the card (the JAX
package's ``use_pallas_ks`` gate). The radix-2 transforms are plain torch on
every device, each a CUDA graph on the card (:class:`..core.ntt.Radix2Ntt`).

The JAX package caches two jitted transforms on its context, the seed
expansion's (``ctx._expand_a_jit``) and the tools' encoding NTT
(``ctx._api_ntt_jit``); :meth:`CkksContext.cached` is their counterpart, a
CUDA graph per JAX key and input signature on the card.
"""

from __future__ import annotations

import functools
import warnings
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..core import primes
from ..core.modarith import u64_to_i64
from ..core.ntt import NttBasis, Radix2Ntt
from ..core.rns import BaseExtender
from ..ops import cuda_ntt
from ..utils import graphs, profiling

# the reference artifacts' chain and roots (ppqsflhe_tpu/ckks/params.py:36-37)
REFERENCE_MODULI = (1152921504606748673, 1099510054913, 1099511922689, 557057)
REFERENCE_ROOTS = (62213374832584, 42618759, 36692422, 19)


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
    # the four-step NTT's implementation, by its JAX name: "pallas_mxu",
    # "xla" or "mxu" (the digit-matmul route: kernels 1, 1b, 4, 5) or
    # "pallas" (butterfly: kernel 6); all give the same evaluations, bit for
    # bit. The name is kept as given, so a CC document re-emits unchanged.
    ntt_impl: str = cuda_ntt.MXU
    # "fourstep" or "radix2". The JAX package defaults to "radix2" (and a CC
    # document without the key reads as radix-2, ckks/serialize.py); the
    # port's in-memory default stays the four-step order its kernels run in.
    ntt_backend: str = "fourstep"
    # FLEXIBLEAUTOEXT: the chain ends with a small extra prime; fresh
    # full-level plaintexts encode at Δ·q_ext and the extension limb is
    # dropped (rescaled away) before the first multiplication
    flexible_ext: bool = False
    # PRE mode: "INDCPA" (one key switch) or "INDCCA" (plus Enc_pk(0) and
    # uniform flooding of 2^pre_flood_bits on every re-encryption)
    pre_mode: str = "INDCPA"
    pre_flood_bits: int = 30

    def __post_init__(self):
        if self.ntt_backend not in ("fourstep", "radix2"):
            raise ValueError(f"ntt_backend={self.ntt_backend!r}: 'fourstep' or 'radix2'")
        if self.ntt_impl not in cuda_ntt.RUNNER:
            raise ValueError(f"unknown ntt_impl {self.ntt_impl!r} "
                             f"(one of {sorted(cuda_ntt.RUNNER)})")
        if self.pre_mode not in ("INDCPA", "INDCCA"):
            raise ValueError(f"unsupported PREMode {self.pre_mode!r} (INDCPA or INDCCA)")

    @staticmethod
    def generate(n: int = 1 << 14, mult_depth: int = 2, scale_bits: int = 40,
                 first_mod_bits: int = 60, dnum: int = 2, slots: int = 0,
                 extra_mod_bits: int = 0, ntt_impl: str = cuda_ntt.MXU,
                 ntt_backend: str = "fourstep") -> "CkksParams":
        """A fresh NTT-friendly chain, OpenFHE-style: one first modulus of
        ``first_mod_bits``, ``mult_depth`` scaling primes of ``scale_bits``,
        with ``extra_mod_bits`` a FLEXIBLEAUTOEXT extension prime of that
        many bits, and enough 60-bit special primes to cover the largest KS
        digit — the same primes as ``ppqsflhe_tpu``'s ``CkksParams.generate``."""
        m = 2 * n
        q = [primes.first_prime_down(first_mod_bits, m)]
        q += primes.prime_chain(scale_bits, mult_depth, m, avoid=set(q))
        if extra_mod_bits:
            q += [primes.next_prime_up(1 << (extra_mod_bits - 1), m)]
        alpha = -(-len(q) // dnum)
        digit_bits = max(
            sum(int(x).bit_length() for x in q[i * alpha : (i + 1) * alpha])
            for i in range(dnum)
        )
        n_special = max(1, -(-digit_bits // 60))
        p = primes.prime_chain(60, n_special, m, avoid=set(q))
        return CkksParams(n=n, q_moduli=tuple(q), p_moduli=tuple(p),
                          scale_bits=scale_bits, dnum=dnum, slots=slots or n // 2,
                          ntt_impl=ntt_impl, ntt_backend=ntt_backend,
                          flexible_ext=bool(extra_mod_bits))

    @staticmethod
    def reference(slots: int = 8192) -> "CkksParams":
        """The exact chain of the reference's checked-in artifacts (the JAX
        package's ``CkksParams.reference``), in the radix-2 order."""
        m = 2 * (1 << 14)
        p = tuple(primes.prime_chain(60, 2, m, avoid=set(REFERENCE_MODULI)))
        return CkksParams(n=1 << 14, q_moduli=REFERENCE_MODULI, p_moduli=p,
                          q_roots=REFERENCE_ROOTS, scale_bits=40, dnum=2, slots=slots,
                          ntt_backend="radix2", ntt_impl="xla")

    @property
    def num_q(self) -> int:
        return len(self.q_moduli)

    @property
    def num_p(self) -> int:
        return len(self.p_moduli)

    @property
    def scale(self) -> float:
        return float(2 ** self.scale_bits)

    def security_bits(self) -> int:
        """Conservative classical security estimate from the HE-standard
        tables (homomorphicencryption.org v1.1, ternary secret): the largest
        standard level (128/192/256) whose log2(QP) bound admits this
        parameter set, or 0 below 128-bit. A diagnostic, not a gate."""
        logqp = sum(int(q).bit_length() for q in self.q_moduli + self.p_moduli)
        # HE-standard max log2(Q) for ternary secrets (classical)
        table = {
            1024: (27, 19, 14), 2048: (54, 37, 29), 4096: (109, 75, 58),
            8192: (218, 152, 118), 16384: (438, 305, 237),
            32768: (881, 611, 476), 65536: (1772, 1228, 956),
        }
        key = min((k for k in table if k >= self.n), default=None)
        if key is None:
            return 256  # beyond table: deeply conservative rings
        b128, b192, b256 = table[key]
        if logqp <= b256:
            return 256
        if logqp <= b192:
            return 192
        if logqp <= b128:
            return 128
        return 0


class SecurityWarning(UserWarning):
    """Raised (as a warning) when a context is built below 128-bit security."""


class CkksContext:
    """Derived tables + lazily cached per-level precomputes."""

    # whether CkksScheme may cache a CUDA graph per operation on this
    # context (a context whose transforms run collectives may not)
    per_op_graphs = True

    def __init__(self, params: CkksParams):
        self.params = params
        self.local_n = params.n     # the trailing width of the polys it transforms
        # parameters are taken as given (HEStd_NotSet), but a sub-128-bit
        # chain is surfaced when the context is built
        bits = params.security_bits()
        if bits < 128:
            warnings.warn(
                f"CKKS parameters (N={params.n}, log2(QP)="
                f"{sum(int(q).bit_length() for q in params.q_moduli + params.p_moduli)}) "
                f"fall below 128-bit HE-standard security (estimate: {bits}-bit)",
                SecurityWarning,
                stacklevel=2,
            )
        self.moduli_qp = tuple(params.q_moduli) + tuple(params.p_moduli)
        roots = None
        if params.q_roots is not None:
            p_roots = params.p_roots or tuple(
                primes.root_of_unity(2 * params.n, p) for p in params.p_moduli)
            roots = tuple(params.q_roots) + p_roots
        self.basis = NttBasis(params.n, self.moduli_qp, roots)
        self.radix2 = params.ntt_backend == "radix2"
        self.fntt = (Radix2Ntt(self.basis) if self.radix2 else cuda_ntt.four_step_ntt(
            params.n, self.moduli_qp, self.basis.psis, cuda_ntt.RUNNER[params.ntt_impl]))
        self._dev: Dict[tuple, torch.Tensor] = {}
        self._graphs = graphs.GraphCache()
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

    def cached(self, key, what: str, body, *inputs, scrub: bool = False):
        """``body(*inputs)`` through the context's graph cache under the JAX
        key ``key`` (``("expand_a", l)``, ``("api_ntt", l)``) plus the
        inputs' signatures; ``what`` names it in a failed capture's error,
        ``scrub`` zeroes the graph's static buffers after every call. Eager
        on the CPU, inside :func:`..utils.graphs.eager`, during another
        capture and where ``per_op_graphs`` is off."""
        if not self.per_op_graphs:
            return body(*inputs)
        return graphs.cached(self._graphs, key, what, body, *inputs, scrub=scrub)

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
        with profiling.span("ntt"):
            return self.fntt.ntt(a, idx=tuple(idx))

    def intt(self, a: torch.Tensor, idx: Sequence[int]) -> torch.Tensor:
        with profiling.span("ntt"):
            return self.fntt.intt(a, idx=tuple(idx))

    def galois_perm(self, g: int, device="cuda") -> torch.Tensor:
        """Eval-order permutation for the automorphism X→X^g in the
        backend's order (new[i] = old[perm[i]]): the bit-reversed one as it
        is for radix-2, corrected for the kernel order for four-step; a long
        tensor on ``device``, cached per g and device."""
        k = (("galois", g), str(device))
        if k not in self._dev:
            from .eval import _galois_perm

            P = _galois_perm(self.params.n, g)
            if not self.radix2:
                T = self.fntt.perm_to_std
                P = T[P[np.argsort(T)]]
            self._dev[k] = torch.as_tensor(P, device=device)
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
