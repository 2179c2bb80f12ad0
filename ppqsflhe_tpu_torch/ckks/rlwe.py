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

Each randomized function is its draws (``*_draws``: one sampler call of
each kind over the whole batch, on the caller's generator) followed by its
body (``*_body``: the deterministic device work on those draws), so that
:class:`.scheme.CkksScheme` can run the body through its graph cache.
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
    """Small signed ints [..., N] → eval-domain residues over limbs `idx`
    (the moduli from the context's device columns: no upload)."""
    q, _, _ = ctx.limb_consts(idx, v_int.device)
    v64 = v_int.to(torch.int64).unsqueeze(-2)
    return ctx.ntt(torch.where(v64 < 0, q + v64, v64), idx)


def _shape(ctx: CkksContext, lead) -> tuple:
    return tuple(lead) + (ctx.params.n,)


# -- key generation ---------------------------------------------------------

def keygen_draws(ctx: CkksContext, gen: torch.Generator, device,
                 a_seed: bytes | None = None) -> tuple:
    """keygen's draws: the ternary secret s (int32[N]), ``a`` in the
    coefficient domain (int64[L+K, N]: uniform, or expanded from
    ``a_seed`` on the host) and the Gaussian error e (int32[N])."""
    n = ctx.params.n
    s_int = sampling.ternary(gen, n, device)
    if a_seed is not None:
        a = torch.from_numpy(_expand_coeff(ctx, a_seed, len(ctx.moduli_qp)).view(np.int64))
        a = a.to(device)
    else:
        a = sampling.uniform_rns(gen, ctx.moduli_qp, n, device)
    return s_int, a, sampling.discrete_gaussian(gen, n, ctx.params.sigma, device)


def keygen_body(ctx: CkksContext, s_int: torch.Tensor, a: torch.Tensor,
                e_int: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """keygen's device work on its draws → (s_eval, pk data (b, a)) with
    b = -a*s + e over QP."""
    all_idx = tuple(range(len(ctx.moduli_qp)))
    s_eval = _signed_to_eval(ctx, s_int, all_idx)
    a = ctx.ntt(a, all_idx)
    q, _, _ = ctx.limb_consts(all_idx, a.device)
    b = modadd(modneg(_poly_mul(ctx, a, s_eval, all_idx), q),
               _signed_to_eval(ctx, e_int, all_idx), q)
    return s_eval, torch.stack([b, a])


def keys_of(s_int: torch.Tensor, s_eval: torch.Tensor,
            pk_data: torch.Tensor) -> tuple[SecretKey, PublicKey]:
    """The key pair from keygen's secret draw and its body's outputs (the
    secret's host copy is the one host sync of key generation)."""
    sk = SecretKey(s_eval=s_eval, s_int=s_int.cpu().numpy().astype(np.int8))
    return sk, PublicKey(data=pk_data)


def keygen(ctx: CkksContext, gen: torch.Generator, device,
           a_seed: bytes | None = None) -> tuple[SecretKey, PublicKey]:
    """Ternary secret, pk = (b, a) with b = -a*s + e over QP. With
    ``a_seed`` (16 bytes), a = expand_a(seed): the serialized public key
    then ships b and the seed."""
    draws = keygen_draws(ctx, gen, device, a_seed)
    return keys_of(draws[0], *keygen_body(ctx, *draws))


# -- public-key encryption --------------------------------------------------

def encrypt_draws(ctx: CkksContext, gen: torch.Generator, lead, device) -> tuple:
    """A pk encryption's draws for the batch shape ``lead``: u ternary
    (int32[*lead, N]) and the Gaussian e0, e1 as one draw
    (int32[2, *lead, N]); one sampler call of each kind."""
    shape = _shape(ctx, lead)
    return (sampling.ternary(gen, shape, device),
            sampling.discrete_gaussian(gen, (2,) + shape, ctx.params.sigma, device))


def _pk_zero(ctx: CkksContext, pk: PublicKey, l: int, u: torch.Tensor, e: torch.Tensor):
    """(b*u + e0, a*u + e1) over the first ``l`` Q limbs from the draws of
    :func:`encrypt_draws`."""
    idx = ctx.q_idx(l)
    q, _, _ = ctx.limb_consts(idx, u.device)
    u = _signed_to_eval(ctx, u, idx)
    e = _signed_to_eval(ctx, e, idx)
    c0 = modadd(_poly_mul(ctx, pk.data[0, :l], u, idx), e[0], q)
    c1 = modadd(_poly_mul(ctx, pk.data[1, :l], u, idx), e[1], q)
    return c0, c1


def encrypt_body(ctx: CkksContext, pk: PublicKey, pt: Plaintext, u: torch.Tensor,
                 e: torch.Tensor) -> Ciphertext:
    """:func:`encrypt`'s device work on its draws."""
    l = pt.nlimbs
    c0, c1 = _pk_zero(ctx, pk, l, u, e)
    q, _, _ = ctx.limb_consts(ctx.q_idx(l), pt.data.device)
    return Ciphertext(data=torch.stack([modadd(c0, pt.data, q), c1], dim=-3), scale=pt.scale)


def encrypt(ctx: CkksContext, pk: PublicKey, pt: Plaintext,
            gen: torch.Generator) -> Ciphertext:
    """ct = (b*u + e0 + m, a*u + e1) over the plaintext's active Q limbs;
    ``pt.data`` may carry leading batch dims (fresh u, e0, e1 per entry)."""
    draws = encrypt_draws(ctx, gen, pt.data.shape[:-2], pt.data.device)
    return encrypt_body(ctx, pk, pt, *draws)


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
    ``nlimbs`` limbs, int64[len(seeds), nlimbs, N]: the host expansion and
    one upload, then ONE batched forward transform on ``device`` through
    the context's cache under the JAX key ``("expand_a", nlimbs)``."""
    idx = ctx.q_idx(nlimbs)
    coeff = np.stack([_expand_coeff(ctx, sd, nlimbs) for sd in seeds])
    return ctx.cached(("expand_a", nlimbs), "the seed expansion", lambda c: ctx.ntt(c, idx),
                      torch.from_numpy(coeff.view(np.int64)).to(device))


def expand_a(ctx: CkksContext, seed: bytes, nlimbs: int, device) -> torch.Tensor:
    """Deterministic uniform eval-domain poly over the first ``nlimbs``
    limbs from a 16-byte seed — the mask behind the seeded wire (a fresh
    secret-key ciphertext's c1, a seeded public key's ``a``)."""
    return expand_a_batch(ctx, [seed], nlimbs, device)[0]


def encrypt_sk_body(ctx: CkksContext, s_eval: torch.Tensor, pt: Plaintext, a: torch.Tensor,
                    e: torch.Tensor) -> Ciphertext:
    """:func:`encrypt_sk`'s device work: the eval-domain masks ``a`` (the
    plaintext's shape) and the Gaussian error ``e`` (int32[*lead, N])."""
    l = pt.nlimbs
    idx = ctx.q_idx(l)
    q, _, _ = ctx.limb_consts(idx, pt.data.device)
    e = _signed_to_eval(ctx, e, idx)
    c0 = modadd(modadd(modneg(_poly_mul(ctx, a, s_eval[:l], idx), q), e, q), pt.data, q)
    return Ciphertext(data=torch.stack([c0, a], dim=-3), scale=pt.scale)


def encrypt_sk_draws(ctx: CkksContext, gen: torch.Generator, pt: Plaintext, a_seed) -> tuple:
    """:func:`encrypt_sk`'s draws: the eval-domain masks ``a`` expanded
    from ``a_seed`` (the plaintext's shape) and the Gaussian error ``e``
    (int32[*lead, N], one sampler call)."""
    dev = pt.data.device
    seeds = [a_seed] if isinstance(a_seed, (bytes, bytearray)) else list(a_seed)
    a = expand_a_batch(ctx, seeds, pt.nlimbs, dev).reshape(pt.data.shape)
    return a, sampling.discrete_gaussian(gen, pt.data.shape[:-2] + (ctx.params.n,),
                                         ctx.params.sigma, dev)


def encrypt_sk(ctx: CkksContext, sk: SecretKey, pt: Plaintext, gen: torch.Generator,
               a_seed) -> Ciphertext:
    """Symmetric encryption with a seed-expanded mask: ct = (-a·s + e + m,
    a) with a = expand_a(a_seed). ``a_seed`` is one 16-byte seed, or one
    per entry of a batched plaintext (B, l, N). Decrypts and re-encrypts
    like a pk ciphertext; the wire can drop c1 (PQTC v3)."""
    return encrypt_sk_body(ctx, sk.s_eval, pt, *encrypt_sk_draws(ctx, gen, pt, a_seed))


def zero_draws(ctx: CkksContext, gen: torch.Generator, lead, device,
               flood_bits: int = 0) -> tuple:
    """:func:`encrypt_zero`'s draws: :func:`encrypt_draws`' u and e, then
    with ``flood_bits`` > 0 the uniform flood (int64[*lead, N]); one
    sampler call of each kind."""
    draws = encrypt_draws(ctx, gen, lead, device)
    if flood_bits > 0:
        draws += (sampling.uniform_signed(gen, _shape(ctx, lead), flood_bits, device),)
    return draws


def encrypt_zero_body(ctx: CkksContext, pk: PublicKey, nlimbs: int, u: torch.Tensor,
                      e: torch.Tensor, flood: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`encrypt_zero`'s device work on the draws of :func:`zero_draws`."""
    c0, c1 = _pk_zero(ctx, pk, nlimbs, u, e)
    if flood is not None:
        idx = ctx.q_idx(nlimbs)
        q, _, _ = ctx.limb_consts(idx, u.device)
        c0 = modadd(c0, _signed_to_eval(ctx, flood, idx), q)
    return torch.stack([c0, c1], dim=-3)


def encrypt_zero(ctx: CkksContext, pk: PublicKey, nlimbs: int, gen: torch.Generator,
                 flood_bits: int = 0, lead=(), device="cuda") -> torch.Tensor:
    """Fresh pk-encryption of zero over the first ``nlimbs`` Q limbs, with
    uniform flooding noise of magnitude 2^flood_bits added to c0: the
    re-randomizer of INDCCA re-encryption. Raw eval-domain data
    int64[*lead, 2, nlimbs, N], fresh randomness per batch entry."""
    return encrypt_zero_body(ctx, pk, nlimbs, *zero_draws(ctx, gen, lead, device, flood_bits))


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
