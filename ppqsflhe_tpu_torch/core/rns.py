"""RNS basis utilities: host CRT compose/decompose and the HPS base extender.

Twin of :mod:`ppqsflhe_tpu.core.rns`. The compose/decompose pair is host
big-int code (copied). :class:`BaseExtender` holds the per-(src, dst)
constants; its plain ``extend`` is torch int64 code. The CUDA kernel that
replaces it on the card lives in :mod:`..ops.cuda_ext`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import primes
from .modarith import INT64_MIN, modadd, modsub, shoup_mul, shoup_mul_wide, u64_to_i64


# ---------------------------------------------------------------------------
# Host-side exact compose/decompose (Python big ints via object arrays)
# ---------------------------------------------------------------------------

def decompose_int(values, moduli: Sequence[int]) -> np.ndarray:
    """Integers (possibly negative, arbitrary precision) → residues u64[L, N]."""
    vals = np.asarray(values, dtype=object)
    out = np.zeros((len(moduli),) + vals.shape, dtype=np.uint64)
    for i, q in enumerate(moduli):
        out[i] = np.array([int(v) % q for v in vals.ravel()], dtype=np.uint64).reshape(vals.shape)
    return out


def compose_int(residues, moduli: Sequence[int]) -> np.ndarray:
    """Residues u64[L, N] → exact integers in [0, Q) as an object array."""
    res = np.asarray(residues)
    L = len(moduli)
    Q = 1
    for q in moduli:
        Q *= q
    coeffs = []
    for i, q in enumerate(moduli):
        Qi = Q // q
        coeffs.append((Qi * primes.mod_inverse(Qi % q, q)) % Q)
    flat = res.reshape(L, -1)
    n = flat.shape[1]
    out = np.zeros(n, dtype=object)
    for i in range(L):
        ci = coeffs[i]
        col = flat[i]
        for j in range(n):
            out[j] += int(col[j]) * ci
    for j in range(n):
        out[j] %= Q
    return out.reshape(res.shape[1:])


def compose_centered(residues, moduli: Sequence[int]) -> np.ndarray:
    """Residues → centered integers in (-Q/2, Q/2] (object array)."""
    Q = 1
    for q in moduli:
        Q *= q
    vals = compose_int(residues, moduli)
    flat = vals.ravel()
    for j in range(flat.size):
        if flat[j] > Q // 2:
            flat[j] -= Q
    return vals


# ---------------------------------------------------------------------------
# HPS fast base extension (coefficient domain)
# ---------------------------------------------------------------------------

class BaseExtender:
    """Fast base extension from basis ``src`` to basis ``dst`` (HPS 2016).

    y_i = [x_i·(D/d_i)^{-1}]_{d_i}; alpha = carries + round bit of the
    wrapping Q0.64 sum Σ y_i·round(2^64/d_i); z_j = Σ_i y_i·[D/d_i]_{p_j}
    − alpha·[D]_{p_j} mod p_j. Constants are host numpy int64 (bit patterns
    of the unsigned values); :meth:`tables` gives them per device."""

    def __init__(self, src: Sequence[int], dst: Sequence[int]):
        self.src = tuple(int(q) for q in src)
        self.dst = tuple(int(q) for q in dst)
        D = 1
        for q in self.src:
            D *= q
        self.dhat_inv = [primes.mod_inverse((D // q) % q, q) for q in self.src]
        self.recip = [((1 << 64) + q // 2) // q for q in self.src]
        self.dhat_mod_dst = [[(D // q) % p for q in self.src] for p in self.dst]
        self.d_mod_dst = [D % p for p in self.dst]
        self.cache: dict = {}

    def src_consts(self, pre=None):
        """Per-src (C_i, Shoup(C_i)) with C_i = [(D/d_i)^{-1}·pre_i]_{d_i}."""
        c = [(v * (1 if pre is None else int(pre[i]))) % q
             for i, (v, q) in enumerate(zip(self.dhat_inv, self.src))]
        return c, [primes.shoup_precompute(v, q) for v, q in zip(c, self.src)]

    def tables(self, device, pre=None):
        """int64 constant tensors on ``device`` for the plain ``extend``."""
        key = (str(device), None if pre is None else tuple(int(v) for v in pre))
        t = self.cache.get(key)
        if t is None:
            ls, ld = len(self.src), len(self.dst)
            c, c_sh = self.src_consts(pre)
            dm = self.dhat_mod_dst
            cols = lambda v: torch.as_tensor(u64_to_i64(v), device=device).reshape(-1, 1)
            t = self.cache[key] = dict(
                src_q=cols(self.src), c=cols(c), c_sh=cols(c_sh),
                recip=cols(self.recip), dst_q=cols(self.dst),
                dmat=torch.as_tensor(u64_to_i64(dm), device=device).reshape(ld, ls),
                dmat_sh=torch.as_tensor(u64_to_i64(
                    [[primes.shoup_precompute(dm[j][i], p) for i in range(ls)]
                     for j, p in enumerate(self.dst)]), device=device).reshape(ld, ls),
                dcor=cols(self.d_mod_dst),
                dcor_sh=cols([primes.shoup_precompute(v, p)
                              for v, p in zip(self.d_mod_dst, self.dst)]),
            )
        return t

    def extend(self, x: torch.Tensor, pre=None) -> torch.Tensor:
        """x: int64[..., ls, N] coefficient-domain residues → int64[..., ld, N].
        ``pre`` (ints, one per src limb) folds a constant into y's multiply
        (the key-switch digit decomposition's [Q̂_j^{-1}]_{q_i})."""
        t = self.tables(x.device, pre)
        y = shoup_mul(x, t["c"], t["c_sh"], t["src_q"])
        frac = y * t["recip"]                           # wrapping low product
        acc = frac[..., 0:1, :]
        carry = torch.zeros_like(acc)
        for i in range(1, len(self.src)):
            nxt = acc + frac[..., i : i + 1, :]         # wrapping
            # unsigned nxt < acc: flip the sign bits, compare signed
            carry = carry + ((nxt ^ INT64_MIN) < (acc ^ INT64_MIN)).to(torch.int64)
            acc = nxt
        alpha = carry + ((acc >> 63) & 1)
        ld = len(self.dst)
        out = None
        for i in range(len(self.src)):
            term = shoup_mul_wide(y[..., i : i + 1, :], t["dmat"][:, i : i + 1],
                                  t["dmat_sh"][:, i : i + 1], t["dst_q"])
            out = term if out is None else modadd(out, term, t["dst_q"])
        corr = shoup_mul_wide(alpha.expand(*alpha.shape[:-2], ld, alpha.shape[-1]),
                              t["dcor"], t["dcor_sh"], t["dst_q"])
        return modsub(out, corr, t["dst_q"])
