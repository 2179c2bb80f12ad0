"""RLWE key generation, public-key encryption, decryption.

Twin of :mod:`ppqsflhe_tpu.ckks.rlwe` (unseeded keygen, pk encrypt,
decrypt_to_coeffs, decode_coeffs, decrypt). Keys live over the full QP basis
so that PRE rekey generation can encrypt under the delegatee's public key;
fresh ciphertexts use only the Q part. Everything is in the evaluation
domain at rest. Randomness comes from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import sampling
from ..core.modarith import modadd, modmul, modneg
from .params import CkksContext
from .types import Ciphertext, Plaintext, PublicKey, SecretKey


def _poly_mul(ctx: CkksContext, a, b, idx):
    q, qinv, r2 = ctx.limb_consts(idx, a.device)
    return modmul(a, b, q, qinv, r2)


def _signed_to_eval(ctx: CkksContext, v_int: torch.Tensor, idx):
    """Small signed ints [..., N] → eval-domain residues over limbs `idx`."""
    coeff = sampling.signed_to_rns(v_int, [ctx.moduli_qp[i] for i in idx])
    return ctx.ntt(coeff, idx)


def keygen(ctx: CkksContext, gen: torch.Generator, device) -> tuple[SecretKey, PublicKey]:
    """Ternary secret, pk = (b, a) with b = -a*s + e over QP."""
    n = ctx.params.n
    all_idx = tuple(range(len(ctx.moduli_qp)))
    s_int = sampling.ternary(gen, n, device)
    s_eval = _signed_to_eval(ctx, s_int, all_idx)
    a = ctx.ntt(sampling.uniform_rns(gen, ctx.moduli_qp, n, device), all_idx)
    e = _signed_to_eval(ctx, sampling.discrete_gaussian(gen, n, ctx.params.sigma, device),
                        all_idx)
    q, _, _ = ctx.limb_consts(all_idx, device)
    b = modadd(modneg(_poly_mul(ctx, a, s_eval, all_idx), q), e, q)
    sk = SecretKey(s_eval=s_eval, s_int=s_int.cpu().numpy().astype(np.int8))
    return sk, PublicKey(data=torch.stack([b, a]))


def encrypt(ctx: CkksContext, pk: PublicKey, pt: Plaintext,
            gen: torch.Generator) -> Ciphertext:
    """ct = (b*u + e0 + m, a*u + e1) over the plaintext's active Q limbs;
    ``pt.data`` may carry leading batch dims (fresh u, e0, e1 per entry)."""
    n = ctx.params.n
    l = pt.nlimbs
    idx = ctx.q_idx(l)
    dev = pt.data.device
    q, _, _ = ctx.limb_consts(idx, dev)
    lead = pt.data.shape[:-2]
    count = int(np.prod(lead)) if lead else 1

    def draw(sampler):
        v = torch.stack([sampler() for _ in range(count)]).reshape(lead + (n,))
        return _signed_to_eval(ctx, v, idx)

    u = draw(lambda: sampling.ternary(gen, n, dev))
    e0 = draw(lambda: sampling.discrete_gaussian(gen, n, ctx.params.sigma, dev))
    e1 = draw(lambda: sampling.discrete_gaussian(gen, n, ctx.params.sigma, dev))
    c0 = modadd(modadd(_poly_mul(ctx, pk.data[0, :l], u, idx), e0, q), pt.data, q)
    c1 = modadd(_poly_mul(ctx, pk.data[1, :l], u, idx), e1, q)
    return Ciphertext(data=torch.stack([c0, c1], dim=-3), scale=pt.scale)


def decrypt_to_coeffs(ctx: CkksContext, s_eval: torch.Tensor, ct: Ciphertext) -> torch.Tensor:
    """⟨ct, (1, s, s², …)⟩ then iNTT → coefficient residues int64[..., l, N].
    ``s_eval`` is the full-basis secret eval stack."""
    l = ct.nlimbs
    idx = ctx.q_idx(l)
    q, _, _ = ctx.limb_consts(idx, ct.data.device)
    s = s_eval[:l]
    acc, s_pow = ct.data[..., 0, :, :], s
    for k in range(1, ct.num_components):
        acc = modadd(acc, _poly_mul(ctx, ct.data[..., k, :, :], s_pow, idx), q)
        if k + 1 < ct.num_components:
            s_pow = _poly_mul(ctx, s_pow, s, idx)
    return ctx.intt(acc, idx)


def decode_coeffs(ctx: CkksContext, coeffs: torch.Tensor, ct: Ciphertext, encoder,
                  num: int | None = None, exact: bool = False) -> np.ndarray:
    """Coefficient residues (one ciphertext, [l, N]) → slot values (host).

    Limb 0 is the 60-bit first modulus at every level and |coeff| ≈ Δ·|z| ≪
    q0/2, so the centered limb-0 residue IS the integer coefficient;
    ``exact`` forces the full CRT compose instead."""
    res = coeffs.cpu().numpy()
    l = ct.nlimbs
    moduli = [ctx.moduli_qp[i] for i in range(l)]
    if exact and l > 1:
        from ..core.rns import compose_centered

        centered = compose_centered(res.view(np.uint64), moduli).astype(np.float64)
    else:
        q0 = moduli[0]
        r = res[0]
        centered = np.where(r > q0 // 2, r - q0, r).astype(np.float64)
    return encoder.decode(centered, ct.scale, num).real


def decrypt(ctx: CkksContext, sk: SecretKey, ct: Ciphertext, encoder,
            num: int | None = None) -> np.ndarray:
    """Full decrypt of one ciphertext → decoded real slot values (host)."""
    return decode_coeffs(ctx, decrypt_to_coeffs(ctx, sk.s_eval, ct), ct, encoder, num)
