"""The butterfly four-step NTT: kernel order, tables and the plain transform.

Twin of :mod:`ppqsflhe_tpu.ops.fourstep`. A four-step transform of
N = n1·n2 coefficients (n1 = 2^⌊log2(N)/2⌋) runs

    y = x ⊙ ψ^j                        (negacyclic twist)
    A = n1-point NTTs down the columns of y as an (n1, n2) matrix
    B = A ⊙ T,  T[r][j2] = ω^{rev1(r)·j2}   (twiddle)
    C = n2-point NTTs down the columns of Bᵀ

and leaves evaluation k2·n1 + k1 at position u = rev2(k2)·n1 + rev1(k1)
("kernel order"); :func:`kernel_to_std` maps it to the standard bit-reversed
order of ``core/ntt.py``. Rotations are defined on the standard order, so the
context corrects each Galois permutation by this map.

The column transforms are the constant-geometry (Pease) network of the JAX
package's Pallas kernel (``ntt_body_cg``/``intt_body_cg``): every stage
splits the rows in halves and interleaves sum and twiddled difference, with
Shoup butterflies kept Harvey-lazy (values < 2q between stages). The tables
are the ``u64`` twins of the JAX ``FourStepTables.build``, (value,
⌊value·2^64/q⌋) pairs; the u32 quads were a TPU lane constraint.
:func:`ntt_body_cg` and
:func:`intt_body_cg` are the plain torch transforms (int64, any device);
kernel 6 (``ops/cuda_ntt.py``, ``csrc/fourstep_ntt.cu``) gives the same bits
on the card, in two launches whose plain versions are :func:`ntt_pass1` /
:func:`ntt_pass2` and :func:`intt_pass1` / :func:`intt_pass2`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import primes
from ..core.modarith import shoup_mul, shoup_mul_lazy
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


def _pair(vals: np.ndarray, q: int):
    """(vals, ⌊vals·2^64/q⌋) as uint64 arrays."""
    sh = np.array([(int(v) << 64) // q for v in vals.ravel()], np.uint64).reshape(vals.shape)
    return vals.astype(np.uint64), sh


def _powers(start: int, base: int, count: int, q: int) -> np.ndarray:
    out = np.zeros(count, np.uint64)
    acc = start
    for i in range(count):
        out[i] = acc
        acc = acc * base % q
    return out


def _pease(m: int, root: int, q: int) -> np.ndarray:
    """(S, m/2): row s holds W_s[i] = root^{(i>>s)<<s}, S = log2(m)."""
    i = np.arange(m // 2)
    return np.array([[pow(root, int(e), q) for e in (i >> s) << s]
                     for s in range(m.bit_length() - 1)], np.uint64).reshape(-1, m // 2)


@dataclass
class FourStepTables:
    """Per-modulus tables, each a (value, Shoup companion) uint64 pair."""

    n: int
    n1: int
    n2: int
    q: int
    twist: tuple          # (n1, n2): ψ^{j1·n2+j2}
    itwist: tuple         # (n1, n2): ψ^{-j}·N^{-1}
    twiddle: tuple        # (n1, n2): ω^{rev1(r)·j2}
    itwiddle: tuple       # (n1, n2): ω^{-rev1(r)·j2}
    pgs1: tuple           # (S1, n1/2) Pease rows of the forward n1-point stages
    pgs2: tuple           # (S2, n2/2) forward n2-point
    pct1: tuple           # (S1, n1/2) inverse-root rows, n1-point
    pct2: tuple           # (S2, n2/2) inverse-root rows, n2-point
    _dev: dict = field(default_factory=dict, repr=False)

    @staticmethod
    def build(n: int, q: int, psi: int) -> "FourStepTables":
        n1 = 1 << ((n.bit_length() - 1) // 2)
        n2 = n // n1
        q, psi = int(q), int(psi)
        omega = psi * psi % q
        ipsi = primes.mod_inverse(psi, q)
        iomega = primes.mod_inverse(omega, q)
        twist = _powers(1, psi, n, q).reshape(n1, n2)
        itwist = _powers(primes.mod_inverse(n, q), ipsi, n, q).reshape(n1, n2)
        rev1 = bit_reverse_indices(n1)
        tw = np.stack([_powers(1, pow(omega, int(e), q), n2, q) for e in rev1])
        itw = np.stack([_powers(1, pow(iomega, int(e), q), n2, q) for e in rev1])
        om1, om2 = pow(omega, n2, q), pow(omega, n1, q)    # primitive n1-th / n2-th roots
        iom1, iom2 = primes.mod_inverse(om1, q), primes.mod_inverse(om2, q)
        return FourStepTables(
            n=n, n1=n1, n2=n2, q=q,
            twist=_pair(twist, q), itwist=_pair(itwist, q),
            twiddle=_pair(tw, q), itwiddle=_pair(itw, q),
            pgs1=_pair(_pease(n1, om1, q), q), pgs2=_pair(_pease(n2, om2, q), q),
            pct1=_pair(_pease(n1, iom1, q), q), pct2=_pair(_pease(n2, iom2, q), q))

    def tensor(self, name: str, device) -> tuple:
        """Table ``name`` as an int64 (value, companion) pair on ``device``,
        uploaded once per device."""
        key = (name, str(device))
        if key not in self._dev:
            self._dev[key] = tuple(torch.as_tensor(a.view(np.int64), device=device)
                                   for a in getattr(self, name))
        return self._dev[key]


# ---------------------------------------------------------------------------
# Plain torch transform (per limb; leading batch dims allowed)
# ---------------------------------------------------------------------------

def _col_gs_cg(x: torch.Tensor, tab, q: int) -> torch.Tensor:
    """Pease GS (DIF) cyclic NTT down axis -2 of x (..., m, lanes): natural
    rows in, bit-reversed rows out. Stage s: u = x[:m/2], v = x[m/2:];
    (u + v) mod 2q → even rows, (u − v + 2q)·W_s lazily → odd rows.
    Inputs and outputs < 2q."""
    w, ws = tab
    h, q2 = x.shape[-2] // 2, 2 * q
    for s in range(w.shape[0]):
        u, v = x[..., :h, :], x[..., h:, :]
        t = u + v
        t = torch.where(t >= q2, t - q2, t)
        d = shoup_mul_lazy(u + q2 - v, w[s, :, None], ws[s, :, None], q)
        x = torch.stack([t, d], dim=-2).reshape(x.shape)
    return x


def _col_ct_cg(x: torch.Tensor, tab, q: int) -> torch.Tensor:
    """Inverse of :func:`_col_gs_cg` stage by stage in reverse, without the
    per-stage 1/2 (the N^{-1} sits in itwist). Stage s undone:
    a = x[0::2], b = x[1::2]·W_s^{-1} lazily; a + b → x[:m/2], a − b → x[m/2:],
    each mod 2q. Inputs and outputs < 2q."""
    w, ws = tab
    q2 = 2 * q
    for s in reversed(range(w.shape[0])):
        a = x[..., 0::2, :]
        b = shoup_mul_lazy(x[..., 1::2, :], w[s, :, None], ws[s, :, None], q)
        u = a + b
        v = a + q2 - b
        x = torch.cat([torch.where(u >= q2, u - q2, u), torch.where(v >= q2, v - q2, v)],
                      dim=-2)
    return x


def ntt_pass1(x: torch.Tensor, tabs: FourStepTables) -> torch.Tensor:
    """Forward, kernel 6's first launch: int64 (..., n1, n2) natural-order
    coefficients (values < 4q) → twist, n1-point stages, lazy twiddle,
    transposed: (..., n2, n1), values < 2q."""
    q, dev = tabs.q, x.device
    x = shoup_mul_lazy(x, *tabs.tensor("twist", dev), q)
    x = _col_gs_cg(x, tabs.tensor("pgs1", dev), q)
    return shoup_mul_lazy(x, *tabs.tensor("twiddle", dev), q).transpose(-1, -2)


def ntt_pass2(x: torch.Tensor, tabs: FourStepTables) -> torch.Tensor:
    """Forward, the second launch: n2-point stages and a csub, (..., n2, n1)
    canonical evaluations in kernel order."""
    x = _col_gs_cg(x, tabs.tensor("pgs2", x.device), tabs.q)
    return torch.where(x >= tabs.q, x - tabs.q, x)


def intt_pass1(x: torch.Tensor, tabs: FourStepTables) -> torch.Tensor:
    """Inverse, the first launch: (..., n2, n1) kernel-order evaluations
    (values < 2q) → inverse n2-point stages, transposed, lazy inverse
    twiddle: (..., n1, n2), values < 2q."""
    q, dev = tabs.q, x.device
    x = _col_ct_cg(x, tabs.tensor("pct2", dev), q).transpose(-1, -2)
    return shoup_mul_lazy(x, *tabs.tensor("itwiddle", dev), q)


def intt_pass2(x: torch.Tensor, tabs: FourStepTables) -> torch.Tensor:
    """Inverse, the second launch: inverse n1-point stages and the strict
    itwist (N^{-1} folded in), (..., n1, n2) coefficients in [0, q)."""
    x = _col_ct_cg(x, tabs.tensor("pct1", x.device), tabs.q)
    return shoup_mul(x, *tabs.tensor("itwist", x.device), tabs.q)


def ntt_body_cg(x: torch.Tensor, tabs: FourStepTables) -> torch.Tensor:
    """Forward negacyclic NTT: int64 (..., n1, n2) natural-order
    coefficients (values < 4q) → (..., n2, n1) canonical evaluations in
    kernel order."""
    return ntt_pass2(ntt_pass1(x, tabs), tabs)


def intt_body_cg(x: torch.Tensor, tabs: FourStepTables) -> torch.Tensor:
    """Inverse: (..., n2, n1) kernel-order evaluations (values < 2q) →
    (..., n1, n2) natural-order coefficients in [0, q)."""
    return intt_pass2(intt_pass1(x, tabs), tabs)
