"""Digit-matmul four-step NTT: tables and the plain torch transform.

Twin of :mod:`ppqsflhe_tpu.ops.mxu_ntt`. The four-step factorization's
column transforms are m×m matrix products mod q (m = n1, n2 ≤ 256), run as
EXACT int8 matrix products by 7-bit digit slicing:

- operand residues x < 4q split into nd = ceil((bits(q)+2)/7) digits of
  7 bits (0..127, int8-exact);
- the transform matrix M is premultiplied per input digit,
  V_d = M·2^{7d} mod q, and each V_d is digit-sliced again, giving an int8
  matrix A[(e, k), (d, j)];
- one int8 product with int32 accumulation contracts (d, j): at most
  9·256 terms of ≤ 127², so the sums stay < 2^31;
- the nd output planes P_e recompose as Σ 2^{7e}·P_e mod q through one
  Montgomery reduction by R = 2^{7·split} (the matrices carry the factor
  R), leaving a lazy value < 4q.

Between the two stages sits one elementwise lazy twiddle, a Shoup product
against a (w, ⌊w·2^64/q⌋) pair or, in the Montgomery-twiddle variant, a
lazy Montgomery product against the one table w·2^64 mod q (both < 2q on
inputs < 4q); two conditional subtracts at the end give canonical [0, q)
residues. Output
order is the four-step kernel order u = rev2(k2)·n1 + rev1(k1)
(``ppqsflhe_tpu.ops.fourstep.kernel_to_std``), so the results are bit-equal
to every four-step implementation of the JAX package.

The table builders are the JAX package's host numpy code; the twiddles are
kept as (w, ⌊w·2^64/q⌋) 64-bit pairs instead of u32 quads. The plain
transforms (:func:`mxu_ntt_limb`, :func:`mxu_intt_limb`) run the int8
product through ``torch._int_mm``; :func:`stage_a` and :func:`stage_b` are
the same transform cut at the transpose into two passes, the digit-matmul
twins of ``PallasMxuNttBig``'s stages. The port runs both routes as Shoup
butterflies (kernels 1, 1b: :mod:`.cuda_mxu_ntt`; 4, 5:
:mod:`.streamed_ntt`), and these stay as the reference its tests hold them
to: the canonical outputs are the same.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import primes
from ..core.modarith import mont_mul_lazy, shoup_mul_lazy
from ..core.ntt import bit_reverse_indices

DIGIT_BITS = 7
DIGIT_MASK = (1 << DIGIT_BITS) - 1


def _digit_count(q: int) -> int:
    # operands may be lazy (< 4q), so cover bits(q) + 2
    return -(-(int(q).bit_length() + 2) // DIGIT_BITS)


def _slice_matrix(m_modq: np.ndarray, q: int, nd: int) -> np.ndarray:
    """M (k×j, mod q) → int8 A[e, k, (d·j_dim + j)]: digit e of M·2^{7d}."""
    k_dim, j_dim = m_modq.shape
    a = np.zeros((nd, k_dim, nd * j_dim), np.int8)
    for d in range(nd):
        vd = ((m_modq.astype(object) * (1 << (DIGIT_BITS * d))) % q).astype(np.uint64)
        for e in range(nd):
            dig = ((vd >> np.uint64(DIGIT_BITS * e)) & np.uint64(DIGIT_MASK)).astype(np.int8)
            a[e, :, d * j_dim : (d + 1) * j_dim] = dig
    return a


def _pow_table(base: int, exps: np.ndarray, q: int) -> np.ndarray:
    """base^exps mod q elementwise (exps may be negative → inverse base)."""
    inv = primes.mod_inverse(base % q, q)
    flat = [pow(base if e >= 0 else inv, abs(int(e)), q) for e in exps.ravel()]
    return np.array(flat, np.uint64).reshape(exps.shape)


def _shoup_pair(w: np.ndarray, q: int):
    """(w, ⌊w·2^64/q⌋) as uint64 arrays, for lazy Shoup multiplies."""
    sh = np.array([(int(x) << 64) // q for x in w.ravel()],
                  np.uint64).reshape(w.shape)
    return w.astype(np.uint64), sh


def _mont_form(w: np.ndarray, q: int) -> np.ndarray:
    """w·2^64 mod q as uint64: mont_mul_lazy(a, w·2^64 mod q) = a·w mod q
    (the twin of ``PallasMxuNtt._mont_twiddle``)."""
    return ((w.astype(object) << 64) % q).astype(np.uint64)


@dataclass
class _Recompose:
    """Static per-modulus plan for plane recomposition (see module doc): the
    digit matrices carry an extra factor R = 2^{7·split} mod q, and
        Y ≡ REDC_R(Σ_{e<split} 2^{7e}·P_e) + Σ_{e≥split} 2^{7(e-split)}·P_e
    with output < 4q (planner-verified). The JAX package keeps a Barrett
    fallback for moduli where no split satisfies the bounds; no chain of
    60/40/20-bit primes at N ≤ 2^16 needs it, and the port raises instead."""

    split: int              # first plane of the high group
    qinv_r: int             # -q^{-1} mod 2^{7·split}


@dataclass
class MxuNttTables:
    """Per-modulus precompute for forward+inverse digit-matmul transforms.
    The four int8 stage matrices (``a1``, ``a2``, ``a2i``, ``a1i``) are built
    on first use: at N=2^16 a 60-bit limb's are 4 × 5.3 MB, and a limb that
    runs the streamed pair (:mod:`.streamed_ntt`) never needs them."""

    n: int
    n1: int
    n2: int
    q: int
    psi: int
    nd: int
    t1: tuple             # uint64 (w, w_shoup), each (n1, n2): ω^{j2·rev1(r)}
    t1i: tuple            # uint64 (w, w_shoup), each (n2, n1): ω^{-j2·rev1(r1)}
    t1m: np.ndarray       # uint64 (n1, n2): t1's w·2^64 mod q (Montgomery twiddle)
    t1im: np.ndarray      # uint64 (n2, n1): t1i's w·2^64 mod q
    qinv64: int           # -q^{-1} mod 2^64, the Montgomery twiddle's constant
    plan: _Recompose
    _mats: dict = field(default_factory=dict, repr=False)

    @staticmethod
    def build(n: int, q: int, psi: int) -> "MxuNttTables":
        n1 = 1 << ((n.bit_length() - 1) // 2)
        n2 = n // n1
        q = int(q)
        psi = int(psi)
        nd = _digit_count(q)
        rev1 = bit_reverse_indices(n1)
        j2 = np.arange(n2)

        # the surviving elementwise twiddle ω^{±j2·k1} (ω = ψ²)
        t1 = _pow_table(psi, 2 * np.outer(rev1, j2), q)
        t1i = _pow_table(psi, -2 * np.outer(j2, rev1), q)

        # recompose plan: split=4 is tried first so every limb of a chain
        # shares one plan (the fused Pallas kernel assumed it)
        pmax = 127 * 127 * nd * max(n1, n2)
        if pmax >= 1 << 31:     # the int8 product accumulates in int32
            raise ValueError(f"{nd} digits x {max(n1, n2)} rows overflow int32 planes")
        plan = None
        for split in (4, 3, 2, 1):
            r_bits = DIGIT_BITS * split
            lo_max = sum(pmax << (DIGIT_BITS * e)
                         for e in range(min(split, nd)))
            hi_max = sum(pmax << (DIGIT_BITS * (e - split))
                         for e in range(split, nd))
            if lo_max < (1 << r_bits) * q \
                    and (lo_max >> r_bits) + q + hi_max < 4 * q \
                    and DIGIT_BITS * max(0, nd - 1 - split) <= 38:
                plan = _Recompose(
                    split=split,
                    qinv_r=(-primes.mod_inverse(q % (1 << r_bits),
                                                1 << r_bits)) % (1 << r_bits))
                break
        if plan is None:
            raise ValueError(f"no REDC recompose plan for q={q} at n={n}")

        return MxuNttTables(
            n=n, n1=n1, n2=n2, q=q, psi=psi, nd=nd,
            t1=_shoup_pair(t1, q), t1i=_shoup_pair(t1i, q),
            t1m=_mont_form(t1, q), t1im=_mont_form(t1i, q),
            qinv64=primes.mont_qinv_neg(q), plan=plan,
        )

    def _matrix(self, name: str) -> np.ndarray:
        """Stage matrix ``name`` as int8 [nd, m, nd·m], built once."""
        if name not in self._mats:
            n1, n2, q, psi = self.n1, self.n2, self.q, self.psi
            rev1, rev2 = bit_reverse_indices(n1), bit_reverse_indices(n2)
            j1, j2 = np.arange(n1), np.arange(n2)
            psi1 = pow(psi, n2, q)          # primitive 2·n1-th root
            om2 = pow(psi, 2 * n1, q)       # primitive n2-th root
            if name == "a1":    # stage-1 fwd: M1[r, j1] = ψ1^{j1·(2·rev1[r]+1)}
                m = _pow_table(psi1, np.outer(2 * rev1 + 1, j1), q)
            elif name == "a2":  # stage-2 fwd: M2[r2, j2] = ψ^{j2}·ω2^{j2·rev2[r2]}
                m = (_pow_table(om2, np.outer(rev2, j2), q).astype(object)
                     * _pow_table(psi, j2, q).astype(object)[None, :])
            elif name == "a2i":  # inverse stage-1: M2i[j2, r2] = ψ^{-j2}·ω2^{-j2·rev2[r2]}
                m = (_pow_table(om2, -np.outer(j2, rev2), q).astype(object)
                     * _pow_table(psi, -j2, q).astype(object)[:, None])
            elif name == "a1i":  # inverse stage-2: M1i[j1, r1] = N^{-1}·ψ1^{-j1·(2·rev1[r1]+1)}
                m = (_pow_table(psi1, -np.outer(j1, 2 * rev1 + 1), q).astype(object)
                     * primes.mod_inverse(self.n % q, q))
            else:
                raise KeyError(name)
            redc_fold = pow(2, DIGIT_BITS * self.plan.split, q)   # cancelled by the REDC
            m = ((m.astype(object) % q * redc_fold) % q).astype(np.uint64)
            self._mats[name] = _slice_matrix(m, q, self.nd)
        return self._mats[name]

    a1 = property(lambda self: self._matrix("a1"))     # [nd, n1, nd·n1] stage-1 fwd (ψ1)
    a2 = property(lambda self: self._matrix("a2"))     # [nd, n2, nd·n2] stage-2 fwd (ω2·ψ^{j2})
    a2i = property(lambda self: self._matrix("a2i"))   # [nd, n2, nd·n2] stage-1 inv
    a1i = property(lambda self: self._matrix("a1i"))   # [nd, n1, nd·n1] stage-2 inv (N^{-1})

    def stage_matrix(self, name: str) -> np.ndarray:
        """A stage's int8 matrix as one (nd·m, nd·m) block: plane-major rows
        (e, k), digit-major contraction (d, j) — the layout both the plain
        product and the CUDA kernel consume."""
        a = self._matrix(name)
        nd, m, _ = a.shape
        return a.reshape(nd * m, nd * m)


# ---------------------------------------------------------------------------
# Plain torch transform (per limb; leading batch dims allowed)
# ---------------------------------------------------------------------------

def _stage(x: torch.Tensor, a: torch.Tensor, tabs: MxuNttTables) -> torch.Tensor:
    """One digit-matmul column transform over axis -2 of x (..., m, c),
    values < 2^{7·nd} → (..., m, c) lazy values < 4q."""
    nd = tabs.nd
    lead, (m, c) = x.shape[:-2], x.shape[-2:]
    flat = x.reshape(-1, m, c).permute(1, 0, 2).reshape(m, -1)     # (m, B·c)
    digs = torch.cat([((flat >> (DIGIT_BITS * d)) & DIGIT_MASK).to(torch.int8)
                      for d in range(nd)])                         # (nd·m, B·c)
    planes = torch._int_mm(a, digs).to(torch.int64).reshape(nd, m, -1, c)
    y = _recompose(planes, tabs)                                   # (m, B, c)
    return y.permute(1, 0, 2).reshape(lead + (m, c))


def _recompose(p: torch.Tensor, tabs: MxuNttTables) -> torch.Tensor:
    """int64 planes (nd, ...) with 0 ≤ P_e < 2^31 → lazy value < 4q."""
    nd, q, plan = tabs.nd, tabs.q, tabs.plan
    rs = DIGIT_BITS * plan.split
    mask = (1 << rs) - 1
    s_lo = p[0]
    for e in range(1, min(plan.split, nd)):
        s_lo = s_lo + (p[e] << (DIGIT_BITS * e))                    # < 2^53
    m = ((s_lo & mask) * plan.qinv_r) & mask
    # (s_lo + m·q) / R without a 128-bit product: split q = qh·R + ql;
    # s_lo + m·ql < 2^57 is divisible by R, and m·qh < 2^60
    u = ((s_lo + m * (q & mask)) >> rs) + m * (q >> rs)
    for e in range(plan.split, nd):
        u = u + (p[e] << (DIGIT_BITS * (e - plan.split)))
    return u


def _strict(x: torch.Tensor, q: int) -> torch.Tensor:
    """[0, 4q) → [0, q) with two conditional subtracts."""
    x = torch.where(x >= 2 * q, x - 2 * q, x)
    return torch.where(x >= q, x - q, x)


def _twiddle(x, pair, q):
    w, ws = (torch.as_tensor(t.view(np.int64), device=x.device) for t in pair)
    return shoup_mul_lazy(x, w, ws, q)


def _twiddle_mont(x, wm, tabs: MxuNttTables):
    """The Montgomery twiddle: x < 4q times the table w·2^64 mod q → < 2q."""
    qinv = int(np.uint64(tabs.qinv64).view(np.int64))
    return mont_mul_lazy(x, torch.as_tensor(wm.view(np.int64), device=x.device), tabs.q, qinv)


def _mat(tabs: MxuNttTables, name: str, device) -> torch.Tensor:
    return torch.as_tensor(tabs.stage_matrix(name), device=device)


def mxu_ntt_limb(x: torch.Tensor, tabs: MxuNttTables, mont: bool = False) -> torch.Tensor:
    """Forward negacyclic NTT of one limb: int64 (..., N) natural-order
    coefficients (values < 4q) → (..., N) canonical evaluations in kernel
    order. ``mont``: the Montgomery twiddle (same outputs)."""
    n1, n2, q = tabs.n1, tabs.n2, tabs.q
    y = x.reshape(x.shape[:-1] + (n1, n2))
    y = _stage(y, _mat(tabs, "a1", x.device), tabs)               # (..., n1, n2)
    y = _twiddle_mont(y, tabs.t1m, tabs) if mont else _twiddle(y, tabs.t1, q)
    y = y.transpose(-1, -2)                                       # (..., n2, n1)
    y = _stage(y, _mat(tabs, "a2", x.device), tabs)
    return _strict(y, q).reshape(x.shape)


def mxu_intt_limb(x: torch.Tensor, tabs: MxuNttTables, mont: bool = False) -> torch.Tensor:
    """Inverse of :func:`mxu_ntt_limb`: kernel-order evaluations →
    natural-order coefficients in [0, q)."""
    n1, n2, q = tabs.n1, tabs.n2, tabs.q
    y = x.reshape(x.shape[:-1] + (n2, n1))
    y = _stage(y, _mat(tabs, "a2i", x.device), tabs)              # (..., n2, n1)
    y = _twiddle_mont(y, tabs.t1im, tabs) if mont else _twiddle(y, tabs.t1i, q)
    y = y.transpose(-1, -2)                                       # (..., n1, n2)
    y = _stage(y, _mat(tabs, "a1i", x.device), tabs)
    return _strict(y, q).reshape(x.shape)


# ---------------------------------------------------------------------------
# The two stages as separate passes (the streamed pair of PallasMxuNttBig)
# ---------------------------------------------------------------------------

def stage_a(x: torch.Tensor, mats: torch.Tensor, tw, tabs) -> torch.Tensor:
    """First column stage with no transpose: x int64 (B, L, m, cols),
    contracted over m → (B, L, m, cols), values < 2q. ``mats``: int8
    (L, nd·m, nd·m), each limb's first-stage matrix; ``tw``: the twiddle
    (w, w_shoup) as uint64 numpy arrays (L, m, cols), already sliced to the
    columns of x; ``tabs``: the L limbs' tables."""
    return torch.stack([_twiddle(_stage(x[:, l], mats[l], t), (tw[0][l], tw[1][l]), t.q)
                        for l, t in enumerate(tabs)], dim=1)


def stage_b(t: torch.Tensor, mats: torch.Tensor, tabs) -> torch.Tensor:
    """Second column stage: t (B, L, rows, m_out), values < 2q, transposed
    and contracted over m_out → (B, L, m_out, rows) canonical residues."""
    return torch.stack([_strict(_stage(t[:, l].transpose(-1, -2), mats[l], tb), tb.q)
                        for l, tb in enumerate(tabs)], dim=1)
