"""Scheme-level data types on torch tensors.

Twin of :mod:`ppqsflhe_tpu.ckks.types`. Ring elements are int64 residue
stacks (..., L_active, N), limb-major, in the evaluation domain (four-step
kernel order) unless a name says _coeff. A ciphertext is (..., k, L, N):
leading dimensions batch many ciphertexts (where the JAX package vmapped),
component 0 is the "b" part, Dec(ct) = Σ_k ct[k]·s^k. ``scale`` is exact
float metadata shared by the batch.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Ciphertext:
    data: torch.Tensor               # int64[..., k, L_active, N], eval domain
    scale: float = 2.0**40

    @property
    def num_components(self) -> int:
        return self.data.shape[-3]

    @property
    def nlimbs(self) -> int:
        return self.data.shape[-2]


@dataclass
class Plaintext:
    data: torch.Tensor               # int64[..., L_active, N], eval domain
    scale: float = 2.0**40

    @property
    def nlimbs(self) -> int:
        return self.data.shape[-2]


@dataclass
class SecretKey:
    s_eval: torch.Tensor             # int64[L+K, N] over the full QP basis
    s_int: np.ndarray = None         # host ternary coefficients (int8)


@dataclass
class PublicKey:
    data: torch.Tensor               # int64[2, L+K, N]: (b, a), b = -a*s + e


@dataclass
class KeySwitchKey:
    """Hybrid key-switch key: per digit j an encryption-like pair (b_j, a_j)
    over QP. ``mont=True`` marks Montgomery-form residues (k·2^64 mod q),
    which the inner product consumes with one Montgomery product per term."""

    data: torch.Tensor               # int64[ndigits, 2, L+K, N]
    mont: bool = False


@dataclass
class EvalKey:
    """Bundle of evaluation keys (relinearization + rotation keys)."""

    relin: KeySwitchKey | None = None
    rotations: dict = field(default_factory=dict)  # rot index -> KeySwitchKey
