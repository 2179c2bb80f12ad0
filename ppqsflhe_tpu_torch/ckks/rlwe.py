"""RLWE key generation, encryption, decryption.

Twin of :mod:`ppqsflhe_tpu.ckks.rlwe`: keygen (optionally with a
seed-expanded ``a``), pk encryption, secret-key encryption with a
seed-expanded mask, the encryption of zero that re-randomizes INDCCA
re-encryptions, decrypt_to_coeffs, decode_coeffs, decrypt. Keys live over
the full QP basis so that PRE rekey generation can encrypt under the
delegatee's public key; fresh ciphertexts use only the Q part. Everything is
in the evaluation domain at rest. Noise comes from an explicit
``torch.Generator``; the seed expansion (:func:`expand_a`) is host numpy
Philox, bit for bit the JAX package's. Leading batch dimensions ride
through encryption: each entry gets its own noise.
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


def _draw(ctx: CkksContext, sampler, lead, idx):
    """One draw of ``sampler()`` (small signed ints [n]) per entry of the
    batch shape ``lead``, to eval-domain residues over limbs ``idx``."""
    count = int(np.prod(lead)) if lead else 1
    v = torch.stack([sampler() for _ in range(count)]).reshape(tuple(lead) + (ctx.params.n,))
    return _signed_to_eval(ctx, v, idx)


def keygen(ctx: CkksContext, gen: torch.Generator, device,
           a_seed: bytes | None = None) -> tuple[SecretKey, PublicKey]:
    """Ternary secret, pk = (b, a) with b = -a*s + e over QP. With
    ``a_seed`` (16 bytes), a = expand_a(seed): the serialized public key
    then ships b and the seed."""
    n = ctx.params.n
    all_idx = tuple(range(len(ctx.moduli_qp)))
    s_int = sampling.ternary(gen, n, device)
    s_eval = _signed_to_eval(ctx, s_int, all_idx)
    if a_seed is not None:
        a = expand_a(ctx, a_seed, len(ctx.moduli_qp), device)
    else:
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
    l = pt.nlimbs
    c0, c1 = _pk_zero(ctx, pk, l, gen, pt.data.shape[:-2], pt.data.device)
    q, _, _ = ctx.limb_consts(ctx.q_idx(l), pt.data.device)
    return Ciphertext(data=torch.stack([modadd(c0, pt.data, q), c1], dim=-3), scale=pt.scale)


def _pk_zero(ctx: CkksContext, pk: PublicKey, l: int, gen: torch.Generator, lead, dev):
    """(b*u + e0, a*u + e1) over the first ``l`` Q limbs, fresh u, e0, e1
    per entry of the batch shape ``lead``."""
    n = ctx.params.n
    idx = ctx.q_idx(l)
    q, _, _ = ctx.limb_consts(idx, dev)
    u = _draw(ctx, lambda: sampling.ternary(gen, n, dev), lead, idx)
    e0 = _draw(ctx, lambda: sampling.discrete_gaussian(gen, n, ctx.params.sigma, dev), lead, idx)
    e1 = _draw(ctx, lambda: sampling.discrete_gaussian(gen, n, ctx.params.sigma, dev), lead, idx)
    c0 = modadd(_poly_mul(ctx, pk.data[0, :l], u, idx), e0, q)
    c1 = modadd(_poly_mul(ctx, pk.data[1, :l], u, idx), e1, q)
    return c0, c1


def _expand_coeff(ctx: CkksContext, seed: bytes, nlimbs: int) -> np.ndarray:
    """Uniform coefficients u64[nlimbs, N] from a 16-byte seed: host numpy
    Philox keyed by the seed, one draw per limb below its modulus."""
    if len(seed) != 16:
        raise ValueError("expand_a seed must be 16 bytes")
    rng = np.random.Generator(np.random.Philox(key=np.frombuffer(seed, dtype=np.uint64)))
    return np.stack([rng.integers(0, int(ctx.moduli_qp[i]), ctx.params.n, dtype=np.uint64)
                     for i in ctx.q_idx(nlimbs)])


def expand_a_batch(ctx: CkksContext, seeds, nlimbs: int, device) -> torch.Tensor:
    """The eval-domain uniform polys of many seeds over the first
    ``nlimbs`` limbs, int64[len(seeds), nlimbs, N], in ONE batched forward
    transform on ``device``."""
    coeff = np.stack([_expand_coeff(ctx, sd, nlimbs) for sd in seeds])
    return ctx.ntt(torch.from_numpy(coeff.view(np.int64)).to(device), ctx.q_idx(nlimbs))


def expand_a(ctx: CkksContext, seed: bytes, nlimbs: int, device) -> torch.Tensor:
    """Deterministic uniform eval-domain poly over the first ``nlimbs``
    limbs from a 16-byte seed — the mask behind the seeded wire (a fresh
    secret-key ciphertext's c1, a seeded public key's ``a``)."""
    return expand_a_batch(ctx, [seed], nlimbs, device)[0]


def encrypt_sk(ctx: CkksContext, sk: SecretKey, pt: Plaintext, gen: torch.Generator,
               a_seed) -> Ciphertext:
    """Symmetric encryption with a seed-expanded mask: ct = (-a·s + e + m,
    a) with a = expand_a(a_seed). ``a_seed`` is one 16-byte seed, or one
    per entry of a batched plaintext (B, l, N). Decrypts and re-encrypts
    like a pk ciphertext; the wire can drop c1 (PQTC v3)."""
    l = pt.nlimbs
    idx = ctx.q_idx(l)
    dev = pt.data.device
    q, _, _ = ctx.limb_consts(idx, dev)
    lead = pt.data.shape[:-2]
    seeds = [a_seed] if isinstance(a_seed, (bytes, bytearray)) else list(a_seed)
    a = expand_a_batch(ctx, seeds, l, dev).reshape(pt.data.shape)
    e = _draw(ctx, lambda: sampling.discrete_gaussian(gen, ctx.params.n, ctx.params.sigma, dev),
              lead, idx)
    c0 = modadd(modadd(modneg(_poly_mul(ctx, a, sk.s_eval[:l], idx), q), e, q), pt.data, q)
    return Ciphertext(data=torch.stack([c0, a], dim=-3), scale=pt.scale)


def encrypt_zero(ctx: CkksContext, pk: PublicKey, nlimbs: int, gen: torch.Generator,
                 flood_bits: int = 0, lead=(), device="cuda") -> torch.Tensor:
    """Fresh pk-encryption of zero over the first ``nlimbs`` Q limbs, with
    uniform flooding noise of magnitude 2^flood_bits added to c0: the
    re-randomizer of INDCCA re-encryption. Raw eval-domain data
    int64[*lead, 2, nlimbs, N], fresh randomness per batch entry."""
    n = ctx.params.n
    idx = ctx.q_idx(nlimbs)
    q, _, _ = ctx.limb_consts(idx, device)
    c0, c1 = _pk_zero(ctx, pk, nlimbs, gen, tuple(lead), device)
    if flood_bits > 0:
        f = _draw(ctx, lambda: sampling.uniform_signed(gen, n, flood_bits, device), lead, idx)
        c0 = modadd(c0, f, q)
    return torch.stack([c0, c1], dim=-3)


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
