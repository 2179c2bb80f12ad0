"""Noise-budget introspection (a test and diagnostic tool).

Twin of :mod:`ppqsflhe_tpu.ckks.noise`. Given the secret key (offline or
test use only), measure a ciphertext's coefficient-domain noise against the
exact encoding of the expected plaintext, and report it in bits: the
distance to the two failure walls,

- decryption: noise_bits must stay well below log2(q0) − 1 (message and
  noise must fit the last remaining modulus);
- precision: the slot error is about 2^(noise_bits − scale_bits) · √N.
"""

from __future__ import annotations

import math

import numpy as np

from ..convert import residues_np
from ..core.rns import compose_centered
from .rlwe import decrypt_to_coeffs
from .types import Ciphertext, SecretKey


def noise_coeffs(sch, sk: SecretKey, ct: Ciphertext, expected_values) -> np.ndarray:
    """The exact noise polynomial e = ⟨ct, sk⟩ − encode(expected) over Z,
    centered (an object array of Python ints)."""
    coeffs = residues_np(decrypt_to_coeffs(sch.ctx, sk.s_eval, ct))
    got = compose_centered(coeffs, sch.ctx.moduli_qp[: ct.nlimbs])
    want = sch.encoder.encode(expected_values, ct.scale)
    return got - np.asarray([int(round(float(w))) for w in want], dtype=object)


def noise_bits(sch, sk: SecretKey, ct: Ciphertext, expected_values) -> float:
    """log2 of the largest |noise coefficient| (0.0 when all are 0)."""
    e = noise_coeffs(sch, sk, ct, expected_values)
    m = max((abs(int(x)) for x in e.ravel()), default=0)
    return math.log2(m) if m > 0 else 0.0


def budget_report(sch, sk: SecretKey, ct: Ciphertext, expected_values) -> dict:
    """Noise bits, the decryption budget left, and the predicted slot
    precision."""
    nb = noise_bits(sch, sk, ct, expected_values)
    q_last_bits = int(sch.ctx.moduli_qp[0]).bit_length()   # limb 0 survives every rescale
    scale_bits = math.log2(ct.scale) if ct.scale > 0 else 0.0
    return {
        "noise_bits": nb,
        "budget_bits": q_last_bits - 1 - nb,
        "scale_bits": scale_bits,
        "predicted_slot_error_log2": nb - scale_bits + 0.5 * math.log2(sch.params.n),
        "nlimbs": ct.nlimbs,
    }
