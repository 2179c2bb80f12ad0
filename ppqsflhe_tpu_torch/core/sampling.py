"""RLWE noise and key sampling on an explicit ``torch.Generator``.

Twin of :mod:`ppqsflhe_tpu.core.sampling`: the same distributions (uniform
ternary secret, the exact CDT discrete Gaussian with σ = 3.19, uniform
flooding noise, per-limb uniform residues), drawn from torch's generator
instead of ``jax.random`` —
so the bits differ from the JAX package's for the same seed, by design.
Each sampler takes a shape, a leading batch shape plus ``(n,)`` (an int
``n`` alone is one entry), and draws the whole batch in one call, where the
JAX tools split one key per entry under ``vmap``. Draws happen on the
generator's device (the CPU for a CPU generator) and the result is moved to
``device`` in one copy.
"""

from __future__ import annotations

import decimal
import functools
import math
from typing import Sequence

import numpy as np
import torch

from .modarith import INT64_MIN, u64_to_i64

SIGMA = 3.19  # OpenFHE default CKKS error std-dev


def _shape(shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def ternary(gen: torch.Generator, shape, device=None) -> torch.Tensor:
    """Uniform ternary secret in {-1, 0, 1}^shape (int32)."""
    return torch.randint(-1, 2, _shape(shape), generator=gen, dtype=torch.int32,
                         device=gen.device).to(device)


@functools.lru_cache(maxsize=8)
def _cdt_thresholds(sigma: float) -> np.ndarray:
    """CDT table for |X|, X ~ D_{Z,σ}: thresholds round(2^64·P(|X| ≤ k)) with
    P(0) halved (uniform sign then makes the output exactly symmetric),
    60-digit Decimal arithmetic, tail cut where ρ_k < 2^-64. Same table as
    the JAX package's (ppqsflhe_tpu/core/sampling.py)."""
    ctx = decimal.Context(prec=60)
    s2 = ctx.multiply(ctx.power(decimal.Decimal(repr(sigma)), 2), 2)
    tail = int(math.ceil(sigma * math.sqrt(2.0 * 64.0 * math.log(2.0)))) + 1
    rho = [ctx.exp(ctx.divide(-decimal.Decimal(k * k), s2))
           for k in range(tail + 1)]
    rho[0] = ctx.divide(rho[0], 2)
    total = decimal.Decimal(0)
    for r in rho:
        total = ctx.add(total, r)
    thr, acc = [], decimal.Decimal(0)
    for k in range(tail):
        acc = ctx.add(acc, rho[k])
        t = int((acc / total * (1 << 64)).to_integral_value(
            rounding=decimal.ROUND_HALF_EVEN))
        thr.append(min(t, (1 << 64) - 1))
    return np.array(thr, dtype=np.uint64)


_CDT_TABLES: dict = {}


def _cdt_table(sigma: float, device) -> torch.Tensor:
    """The CDT thresholds with their sign bit flipped (unsigned order as
    signed int64, ascending) on ``device``, uploaded once per (σ, device)."""
    key = (float(sigma), str(device))
    t = _CDT_TABLES.get(key)
    if t is None:
        thr = torch.from_numpy(u64_to_i64(_cdt_thresholds(float(sigma))))
        t = _CDT_TABLES[key] = (thr ^ INT64_MIN).to(device)
    return t


def discrete_gaussian(gen: torch.Generator, shape, sigma: float = SIGMA,
                      device=None) -> torch.Tensor:
    """Exact discrete Gaussian by CDT inversion: magnitude = #{thresholds ≤
    u} for a uniform 64-bit u, independent uniform sign (int32)."""
    shape = _shape(shape)
    halves = torch.randint(0, 1 << 32, (2,) + shape, generator=gen, dtype=torch.int64,
                           device=gen.device)
    u = (halves[0] << 32) | halves[1]          # uniform 64-bit pattern
    # unsigned thr <= u: flip both sign bits, count in signed order
    mag = torch.searchsorted(_cdt_table(sigma, gen.device), u ^ INT64_MIN, right=True)
    sign = torch.randint(0, 2, shape, generator=gen, dtype=torch.int64, device=gen.device)
    return torch.where(sign == 1, -mag, mag).to(torch.int32).to(device)


def uniform_signed(gen: torch.Generator, shape, bits: int, device=None) -> torch.Tensor:
    """Uniform flooding noise in [-2^bits, 2^bits] (int64): the
    re-randomizer's flooding in INDCCA re-encryption."""
    if bits <= 0:
        return torch.zeros(_shape(shape), dtype=torch.int64, device=device)
    bound = 1 << bits
    return torch.randint(-bound, bound + 1, _shape(shape), generator=gen, dtype=torch.int64,
                         device=gen.device).to(device)


def uniform_rns(gen: torch.Generator, moduli: Sequence[int], shape,
                device=None) -> torch.Tensor:
    """Uniform elements of R_Q in RNS form: int64[*lead, L, n] for
    ``shape`` = (*lead, n), limb i in [0, q_i)."""
    shape = _shape(shape)
    return torch.stack([
        torch.randint(0, int(q), shape, generator=gen, dtype=torch.int64,
                      device=gen.device)
        for q in moduli], dim=-2).to(device)


def signed_to_rns(v: torch.Tensor, moduli: Sequence[int]) -> torch.Tensor:
    """Small signed ints [..., n] → residues int64[..., L, n]."""
    q = torch.as_tensor(moduli, dtype=torch.int64, device=v.device).reshape(-1, 1)
    v64 = v.to(torch.int64).unsqueeze(-2)
    return torch.where(v64 < 0, q + v64, v64)
