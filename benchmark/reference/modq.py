"""Exact arithmetic mod a prime q < 2^60 on int64 tensors, and the
negacyclic transform between coefficients and evaluations, written plainly:
a product a·b mod q is built two bits of a at a time (r ← 4r + c·b mod q, so
nothing leaves int64), and the transform is a textbook radix-2 cyclic NTT
after a twist by ψ^j. Slow per element, but a few hundred elementwise
passes over a whole batch at once, on any device."""

from __future__ import annotations

import functools

import numpy as np
import torch

from .chain import eval_index

_LIMIT = 1 << 60


def mulmod(a: torch.Tensor, b, q: int) -> torch.Tensor:
    """a·b mod q for a, b in [0, q), q < 2^60 (``b`` a tensor that
    broadcasts against ``a``)."""
    if q >= _LIMIT:
        raise ValueError(f"q = {q} ≥ 2^60")
    r = torch.zeros_like(a)
    for shift in range(58, -1, -2):
        r = ((r << 2) + ((a >> shift) & 3) * b) % q      # < 4q + 3q < 2^63
    return r


@functools.lru_cache(maxsize=64)
def _tables(n: int, q: int, psi: int, order: str):
    """Host tables of one (N, q, ψ, layout): the twist ψ^j and its inverse
    with N^-1 folded in, each stage's twiddles, the input bit reversal and
    the layout's evaluation index."""
    omega = psi * psi % q
    pw = np.zeros(n, dtype=np.int64)
    ipw = np.zeros(n, dtype=np.int64)
    ipsi, ninv = pow(psi, -1, q), pow(n, -1, q)
    acc, iacc = 1, ninv
    for j in range(n):
        pw[j], ipw[j] = acc, iacc
        acc, iacc = acc * psi % q, iacc * ipsi % q
    stages = []
    m = 1
    while m < n:
        for w in (pow(omega, n // (2 * m), q), pow(omega, -(n // (2 * m)), q)):
            t, c = np.zeros(m, dtype=np.int64), 1
            for j in range(m):
                t[j], c = c, c * w % q
            stages.append(t)
        m *= 2
    bits = n.bit_length() - 1
    rev = np.array([int(format(i, f"0{bits}b")[::-1], 2) if bits else 0 for i in range(n)])
    return pw, ipw, stages[0::2], stages[1::2], rev, eval_index(n, order)


def _cyclic(x: torch.Tensor, q: int, stages, rev) -> torch.Tensor:
    """Σ_j x_j w^(jk) for every k (w the root behind ``stages``), natural
    order in and out."""
    n = x.shape[-1]
    x = x[..., torch.as_tensor(rev, device=x.device)]
    lead = x.shape[:-1]
    m = 1
    for tw in stages:
        x = x.reshape(*lead, n // (2 * m), 2, m)
        u = x[..., 0, :]
        v = mulmod(x[..., 1, :], torch.as_tensor(tw, device=x.device), q)
        x = torch.stack([(u + v) % q, (u - v) % q], dim=-2)
        m *= 2
    return x.reshape(*lead, n)


def forward(coeffs: torch.Tensor, q: int, psi: int, order: str) -> torch.Tensor:
    """Coefficients in [0, q) → evaluations a(ψ^(2k+1)) in the memory
    layout ``order`` (see :func:`.chain.eval_index`)."""
    n = coeffs.shape[-1]
    pw, _, fwd, _, rev, k = _tables(n, q, psi, order)
    dev = coeffs.device
    evals = _cyclic(mulmod(coeffs, torch.as_tensor(pw, device=dev), q), q, fwd, rev)
    return evals[..., torch.as_tensor(k, device=dev)]


def inverse(evals: torch.Tensor, q: int, psi: int, order: str) -> torch.Tensor:
    """:func:`forward`'s inverse: evaluations in layout ``order`` →
    coefficients in [0, q)."""
    n = evals.shape[-1]
    _, ipw, _, inv, rev, k = _tables(n, q, psi, order)
    dev = evals.device
    natural = torch.empty_like(evals)
    natural[..., torch.as_tensor(k, device=dev)] = evals
    return mulmod(_cyclic(natural, q, inv, rev), torch.as_tensor(ipw, device=dev), q)
