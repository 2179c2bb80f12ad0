"""Homomorphic evaluation.

Twin of :mod:`ppqsflhe_tpu.ckks.eval`: add, sub, negate, add_plain,
mult_plain, mult_scalar, rescale, level_reduce, HYBRID key switching, the
INDCPA and INDCCA re-encryption (the JAX scheme's ``re_encrypt`` bodies),
key-switch key generation (PRE rekeys from a public key, relinearization
and Galois keys from a secret key, with a fresh or a seed-expanded mask),
ct×ct mult with relinearization, and Galois rotations (plain, hoisted,
double-hoisted rotation sums) and conjugation. The KSK for digit j
encrypts P·t·Q̂_j with Q̂_j = Q_full/D_j the full-basis CRT cofactor; the
level-l decomposition multiplies the ciphertext's group-j residues by
[Q̂_j^{-1}]_{q_i} before base extension, so one KSK serves every level.
Leading batch dimensions ride through every function (the JAX package
vmapped instead).

Kernel routing follows the tensor's device: the NTTs go through
``ctx.ntt``/``ctx.intt`` (kernel 1, or kernels 4 and 5 for the limbs that
the JAX runner streams: the 60-bit limbs at N ≥ 2^15), the base extensions
through :func:`..ops.cuda_ext.fused_extend` (kernel 2), and the KSK inner product
through :func:`..ops.cuda_ks.ks_inner_product` (kernel 3) at every digit
count. The JAX package sends one digit to XLA instead
(``ppqsflhe_tpu/ckks/eval.py:274``), which fused it into its neighbours on
the TPU; here the plain version of one digit is a string of int64 torch
launches, so the kernel takes it too (same residues).
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from ..core import primes, sampling
from ..core.modarith import (modadd, modmul, modneg, modsub, mont_mul, shoup_mul,
                             shoup_mul_wide)
from ..core.ntt import bit_reverse_indices
from ..ops.cuda_ext import fused_extend
from ..ops.cuda_ks import ks_inner_product
from ..utils import profiling
from .params import CkksContext
from .types import Ciphertext, KeySwitchKey, Plaintext, PublicKey, SecretKey


# ---------------------------------------------------------------------------
# Linear ops
# ---------------------------------------------------------------------------

def _match(ct1: Ciphertext, ct2: Ciphertext):
    l = min(ct1.nlimbs, ct2.nlimbs)
    if not np.isclose(ct1.scale, ct2.scale, rtol=1e-10):
        raise ValueError(f"scale mismatch: {ct1.scale} vs {ct2.scale}")
    return ct1.data[..., :l, :], ct2.data[..., :l, :], l


def add(ctx: CkksContext, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
    d1, d2, l = _match(ct1, ct2)
    q, _, _ = ctx.limb_consts(ctx.q_idx(l), d1.device)
    return Ciphertext(data=modadd(d1, d2, q), scale=ct1.scale)


def sub(ctx: CkksContext, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
    d1, d2, l = _match(ct1, ct2)
    q, _, _ = ctx.limb_consts(ctx.q_idx(l), d1.device)
    return Ciphertext(data=modsub(d1, d2, q), scale=ct1.scale)


def negate(ctx: CkksContext, ct: Ciphertext) -> Ciphertext:
    q, _, _ = ctx.limb_consts(ctx.q_idx(ct.nlimbs), ct.data.device)
    return Ciphertext(data=modneg(ct.data, q), scale=ct.scale)


def add_plain(ctx: CkksContext, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
    """ct + pt: the plaintext's residues added to c0 over the common limbs."""
    l = min(ct.nlimbs, pt.nlimbs)
    q, _, _ = ctx.limb_consts(ctx.q_idx(l), ct.data.device)
    data = ct.data[..., :l, :].clone()
    data[..., 0, :, :] = modadd(data[..., 0, :, :], pt.data[..., :l, :], q)
    return Ciphertext(data=data, scale=ct.scale)


def mult_plain(ctx: CkksContext, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
    """Pointwise eval-domain product; the scales multiply (rescale
    separately)."""
    l = min(ct.nlimbs, pt.nlimbs)
    q, qinv, r2 = ctx.limb_consts(ctx.q_idx(l), ct.data.device)
    return Ciphertext(data=modmul(ct.data[..., :l, :], pt.data[..., :l, :].unsqueeze(-3),
                                  q, qinv, r2),
                      scale=ct.scale * pt.scale)


def mult_scalar(ctx: CkksContext, ct: Ciphertext, c: float,
                rescale_after: bool = True) -> Ciphertext:
    """EvalMult(ct, double). The constant encodes exactly (no FFT): at scale
    q_last then a rescale, so the ciphertext scale comes out unchanged
    (FLEXIBLEAUTO, the default); with ``rescale_after=False`` at Δ, and the
    scale picks up a Δ factor."""
    l = ct.nlimbs
    idx = ctx.q_idx(l)
    dev = ct.data.device
    q, _, _ = ctx.limb_consts(idx, dev)
    enc_scale = float(ctx.moduli_qp[l - 1]) if rescale_after else ctx.params.scale
    m = int(round(c * enc_scale))
    res = [m % ctx.moduli_qp[i] for i in idx]
    w = ctx.consts(("scalar", m, idx), lambda: res, dev)
    ws = ctx.consts(("scalar_sh", m, idx), lambda: (
        primes.shoup_precompute(r, ctx.moduli_qp[i]) for r, i in zip(res, idx)), dev)
    out = Ciphertext(shoup_mul(ct.data, w, ws, q), scale=ct.scale * enc_scale)
    return rescale(ctx, out) if rescale_after else out


# ---------------------------------------------------------------------------
# Rescale (drop the highest active limb, centered exact division)
# ---------------------------------------------------------------------------

def _reduce_into(x, q, ctx: CkksContext, idx):
    """Reduce residues x < 2^62 into [0, q) per limb: a wide Shoup product
    by the constant 1, whose companion is ⌊2^64/q⌋ = ⌊(2^64−1)/q⌋."""
    ones = torch.ones_like(q)
    sh = ctx.consts(("floor2_64", idx), lambda: (
        ((1 << 64) - 1) // ctx.moduli_qp[i] for i in idx), x.device)
    return shoup_mul_wide(x, ones, sh, q)


def rescale(ctx: CkksContext, ct: Ciphertext) -> Ciphertext:
    l = ct.nlimbs
    if l < 2:
        raise ValueError("cannot rescale a single-limb ciphertext")
    dev = ct.data.device
    ql = ctx.moduli_qp[l - 1]
    rem_idx = ctx.q_idx(l - 1)
    q, _, _ = ctx.limb_consts(rem_idx, dev)
    qlinv, qlinv_sh, ql_mod = ctx.rescale_consts(l, dev)

    last_coeff = ctx.intt(ct.data[..., l - 1 : l, :], (l - 1,))     # (..., k, 1, n)
    r = last_coeff.expand(*ct.data.shape[:-2], l - 1, ct.data.shape[-1])
    pos = _reduce_into(r, q, ctx, rem_idx)
    # centered lift: r - ql when r > ql/2
    lifted = torch.where(r > ql // 2, modsub(pos, ql_mod, q), pos)
    lifted_eval = ctx.ntt(lifted, rem_idx)
    diff = modsub(ct.data[..., : l - 1, :], lifted_eval, q)
    return Ciphertext(data=shoup_mul(diff, qlinv, qlinv_sh, q), scale=ct.scale / float(ql))


def level_reduce(ctx: CkksContext, ct: Ciphertext, target_nlimbs: int) -> Ciphertext:
    """Drop limbs without scaling (modulus reduction)."""
    return Ciphertext(data=ct.data[..., :target_nlimbs, :], scale=ct.scale)


# ---------------------------------------------------------------------------
# Hybrid key switching
# ---------------------------------------------------------------------------

def _ks_decomp_consts(ctx: CkksContext, nlimbs: int):
    """Active digit groups at level nlimbs and, per group, the ints
    [Q̂_j^{-1}]_{q_i} (i in group j)."""
    L = ctx.params.num_q
    QF = 1
    for i in range(L):
        QF *= ctx.moduli_qp[i]
    groups = [tuple(i for i in g if i < nlimbs) for g in ctx.digit_groups]
    groups = [g for g in groups if g]
    out = []
    for g_full, g in zip(ctx.digit_groups, groups):
        Dj = 1
        for i in g_full:
            Dj *= ctx.moduli_qp[i]
        Qhat = QF // Dj
        out.append([primes.mod_inverse(Qhat % ctx.moduli_qp[i], ctx.moduli_qp[i])
                    for i in g])
    return groups, out


def keyswitch_core(ctx: CkksContext, c_eval: torch.Tensor, nlimbs: int):
    """Decompose+extend an eval-domain poly c (int64[..., l, n]) into the
    list of digit polys over the extended basis (active Q + P), eval domain."""
    l = nlimbs
    dev = c_eval.device
    idx_q = ctx.q_idx(l)
    idx_ext = tuple(idx_q) + ctx.p_idx()
    groups, consts = _ks_decomp_consts(ctx, l)
    with profiling.span("ks.decompose"):
        c_coeff = ctx.intt(c_eval, idx_q)
        digits = []
        for g, inv in zip(groups, consts):
            lo, hi = g[0], g[-1] + 1                       # groups are contiguous
            other = tuple(i for i in idx_ext if i not in g)
            # kernel 2 folds the decomposition constant into its first multiply
            ext = fused_extend(c_coeff[..., lo:hi, :], ctx.extender(g, other), pre=inv)
            ext_eval = ctx.ntt(ext, other)
            # own-group rows stay in the eval domain: the constant multiply
            # commutes with the NTT
            qg = ctx.consts(("q", g), lambda: (ctx.moduli_qp[i] for i in g), dev)
            w = ctx.consts(("ghat_inv", l, g), lambda: inv, dev)
            ws = ctx.consts(("ghat_inv_sh", l, g), lambda: (
                primes.shoup_precompute(v, ctx.moduli_qp[i]) for v, i in zip(inv, g)), dev)
            d_eval = shoup_mul(c_eval[..., lo:hi, :], w, ws, qg)
            digits.append(torch.cat([ext_eval[..., :lo, :], d_eval, ext_eval[..., lo:, :]],
                                    dim=-2))
        return digits


def ksk_to_mont(ctx: CkksContext, ksk: KeySwitchKey) -> KeySwitchKey:
    """Key-switch key to Montgomery form (k·2^64 mod q = mont_mul(k, 2^128
    mod q)): the inner product then costs one Montgomery product per term."""
    if ksk.mont:
        return ksk
    q, qinv, r2 = ctx.limb_consts(range(len(ctx.moduli_qp)), ksk.data.device)
    return KeySwitchKey(data=mont_mul(ksk.data, r2, q, qinv), mont=True)


def keyswitch_ip(ctx: CkksContext, digits, ksk: KeySwitchKey, nlimbs: int):
    """The KSK inner product (Σ_j d_j·k_j0, Σ_j d_j·k_j1) over the extended
    basis (active Q + P), eval domain — no ModDown. A key not yet in
    Montgomery form is converted first (same residues as the JAX package's
    modmul path: mont_mul(d, k·2^64) = d·k mod q)."""
    with profiling.span("ks.inner_product"):
        ksk = ksk_to_mont(ctx, ksk)
        sel_ext = tuple(ctx.q_idx(nlimbs)) + ctx.p_idx()
        dev = digits[0].device
        q, qinv, _ = ctx.limb_consts(sel_ext, dev)
        sel = ctx.consts(("limb_map", sel_ext), lambda: sel_ext, dev)
        acc = ks_inner_product(torch.stack(digits, dim=-3), ksk.data, sel, q, qinv)
        return acc[..., 0, :, :], acc[..., 1, :, :]


def _mod_down(ctx: CkksContext, c_ext: torch.Tensor, nlimbs: int) -> torch.Tensor:
    """(c mod Q_l·P) → round(c/P) mod Q_l. c_ext: int64[..., l+K, n]."""
    l = nlimbs
    k = ctx.params.num_p
    dev = c_ext.device
    idx_q = ctx.q_idx(l)
    idx_p = ctx.p_idx()
    q, _, _ = ctx.limb_consts(idx_q, dev)
    pinv, pinv_sh = ctx.moddown_consts(l, dev)
    with profiling.span("ks.mod_down"):
        part_p = ctx.intt(c_ext[..., l : l + k, :], idx_p)
        ext = fused_extend(part_p, ctx.extender(idx_p, tuple(idx_q)))
        ext_eval = ctx.ntt(ext, idx_q)
        diff = modsub(c_ext[..., :l, :], ext_eval, q)
        return shoup_mul(diff, pinv, pinv_sh, q)


def keyswitch_apply(ctx: CkksContext, digits, ksk: KeySwitchKey, nlimbs: int):
    """Inner product with the KSK, then ONE batched ModDown of both
    components. Returns (d0, d1) over the active Q limbs, eval domain."""
    acc0, acc1 = keyswitch_ip(ctx, digits, ksk, nlimbs)
    both = _mod_down(ctx, torch.stack([acc0, acc1]), nlimbs)
    return both[0], both[1]


def keyswitch(ctx: CkksContext, c_eval: torch.Tensor, ksk: KeySwitchKey, nlimbs: int):
    return keyswitch_apply(ctx, keyswitch_core(ctx, c_eval, nlimbs), ksk, nlimbs)


def re_encrypt(ctx: CkksContext, ct: Ciphertext, rekey: KeySwitchKey) -> Ciphertext:
    """INDCPA proxy re-encryption (changeCipherDomain): c1 key-switched
    under ``rekey``, its d0 added to c0; leading batch dimensions ride
    through."""
    with profiling.span("pre"):
        l = ct.nlimbs
        q, _, _ = ctx.limb_consts(ctx.q_idx(l), ct.data.device)
        d0, d1 = keyswitch(ctx, ct.data[..., 1, :, :], rekey, l)
        return Ciphertext(data=torch.stack([modadd(ct.data[..., 0, :, :], d0, q), d1], dim=-3),
                          scale=ct.scale)


def re_encrypt_indcca(ctx: CkksContext, ct: Ciphertext, rekey: KeySwitchKey, pk_to: PublicKey,
                      u: torch.Tensor, e: torch.Tensor,
                      flood: torch.Tensor | None = None) -> Ciphertext:
    """INDCCA proxy re-encryption's device work: :func:`re_encrypt`, then
    a fresh encryption of zero under the TARGET key ``pk_to``, flooded,
    added to it, from the draws of ``rlwe.zero_draws`` (one per ciphertext
    of the batch)."""
    from .rlwe import encrypt_zero_body

    q, _, _ = ctx.limb_consts(ctx.q_idx(ct.nlimbs), ct.data.device)
    z = encrypt_zero_body(ctx, pk_to, ct.nlimbs, u, e, flood)
    return Ciphertext(data=modadd(re_encrypt(ctx, ct, rekey).data, z, q), scale=ct.scale)


# ---------------------------------------------------------------------------
# Key-switch key generation (PRE rekeys; relinearization and Galois keys)
# ---------------------------------------------------------------------------

def _ks_target_factors(ctx: CkksContext):
    """[P·Q̂_j]_{q_i} for all full-basis groups j and Q limbs i, as ints."""
    L = ctx.params.num_q
    QF = 1
    for i in range(L):
        QF *= ctx.moduli_qp[i]
    P = 1
    for p in ctx.params.p_moduli:
        P *= p
    out = []
    for g in ctx.digit_groups:
        Dj = 1
        for i in g:
            Dj *= ctx.moduli_qp[i]
        f = P * (QF // Dj)
        out.append([f % ctx.moduli_qp[i] for i in range(L)])
    return out


def _ksk_digit_seed(a_seed: bytes, j: int) -> bytes:
    """Digit j's 16-byte expansion seed of a seeded key-switch key."""
    import hashlib

    return hashlib.blake2b(a_seed + j.to_bytes(2, "little"), digest_size=16).digest()


def ksk_draws(ctx: CkksContext, gen: torch.Generator, device, pk_path: bool,
              a_seed: bytes | None = None) -> tuple:
    """:func:`keyswitch_key_gen`'s draws for every digit at once, one
    sampler call of each kind. The pk path: u ternary (int32[dnum, N]) and
    the Gaussian e0, e1 (int32[2, dnum, N]). The sk path: the digits' masks
    in the coefficient domain (int64[dnum, L+K, N]: uniform, or expanded
    from ``a_seed`` on the host) and the Gaussian e (int32[dnum, N])."""
    from .rlwe import _expand_coeff

    shape = (len(ctx.digit_groups), ctx.params.n)
    sigma = ctx.params.sigma
    if pk_path:
        return (sampling.ternary(gen, shape, device),
                sampling.discrete_gaussian(gen, (2,) + shape, sigma, device))
    if a_seed is not None:
        a = np.stack([_expand_coeff(ctx, _ksk_digit_seed(a_seed, j), len(ctx.moduli_qp))
                      for j in range(shape[0])])
        a = torch.from_numpy(a.view(np.int64)).to(device)
    else:
        a = sampling.uniform_rns(gen, ctx.moduli_qp, shape, device)
    return a, sampling.discrete_gaussian(gen, shape, sigma, device)


def ksk_body(ctx: CkksContext, target_eval_q: torch.Tensor, key: torch.Tensor,
             pk_path: bool, x: torch.Tensor, e: torch.Tensor) -> KeySwitchKey:
    """:func:`keyswitch_key_gen`'s device work on the draws of
    :func:`ksk_draws` (``x`` = u or the masks), every digit at once:
    ``key`` is the public key's data on the pk path, the secret's
    full-basis eval stack on the sk path."""
    from .rlwe import _poly_mul, _signed_to_eval

    n = ctx.params.n
    L = ctx.params.num_q
    K = ctx.params.num_p
    nd = len(ctx.digit_groups)
    dev = target_eval_q.device
    all_idx = tuple(range(L + K))
    q_all, _, _ = ctx.limb_consts(all_idx, dev)
    q_l, qinv_l, r2_l = ctx.limb_consts(range(L), dev)
    factors = ctx.consts("ks_factors", lambda: (f for row in _ks_target_factors(ctx)
                                                for f in row), dev).reshape(nd, L, 1)
    m_q = modmul(target_eval_q, factors, q_l, qinv_l, r2_l)
    m = torch.cat([m_q, torch.zeros((nd, K, n), dtype=torch.int64, device=dev)], dim=1)
    e = _signed_to_eval(ctx, e, all_idx)
    if pk_path:
        u = _signed_to_eval(ctx, x, all_idx)
        b = modadd(modadd(_poly_mul(ctx, key[0], u, all_idx), e[0], q_all), m, q_all)
        a = modadd(_poly_mul(ctx, key[1], u, all_idx), e[1], q_all)
    else:
        a = ctx.ntt(x, all_idx)
        b = modadd(modadd(modneg(_poly_mul(ctx, a, key, all_idx), q_all), e, q_all), m, q_all)
    return KeySwitchKey(data=torch.stack([b, a], dim=1))


def keyswitch_key_gen(ctx: CkksContext, target_eval_q: torch.Tensor,
                      gen: torch.Generator, pk_to: PublicKey | None = None,
                      sk_to: SecretKey | None = None,
                      a_seed: bytes | None = None) -> KeySwitchKey:
    """KSK keying ``target_eval_q`` (int64[L, n], eval domain): each digit
    row encrypts P·Q̂_j·target over QP, either under the public key
    ``pk_to`` (the INDCPA PRE rekey) or, with ``sk_to``, directly under that
    secret key with a uniform a_j (relinearization, rotation and
    conjugation keys): fresh from ``gen``, or with ``a_seed`` expanded from
    the digit's seed :func:`_ksk_digit_seed` (the seeded wire ships only the
    b rows and the seed)."""
    if (pk_to is None) == (sk_to is None):
        raise ValueError("give exactly one of pk_to and sk_to")
    if a_seed is not None and pk_to is not None:
        raise ValueError("a_seed applies to secret-key KSKs only (the pk path's rows "
                         "are not uniform)")
    pk_path = pk_to is not None
    draws = ksk_draws(ctx, gen, target_eval_q.device, pk_path, a_seed)
    key = pk_to.data if pk_path else sk_to.s_eval
    return ksk_body(ctx, target_eval_q, key, pk_path, *draws)


# ---------------------------------------------------------------------------
# ct×ct multiply + relinearization
# ---------------------------------------------------------------------------

def mult(ctx: CkksContext, ct1: Ciphertext, ct2: Ciphertext,
         relin_key: KeySwitchKey | None = None, rescale_after: bool = True) -> Ciphertext:
    d1, d2, l = _match_scales_any(ct1, ct2)
    q, qinv, r2 = ctx.limb_consts(ctx.q_idx(l), d1.device)
    mul = lambda a, b: modmul(a, b, q, qinv, r2)
    a0, a1 = d1[..., 0, :, :], d1[..., 1, :, :]
    b0, b1 = d2[..., 0, :, :], d2[..., 1, :, :]
    c0 = mul(a0, b0)
    c1 = modadd(mul(a0, b1), mul(a1, b0), q)
    c2 = mul(a1, b1)
    out = Ciphertext(data=torch.stack([c0, c1, c2], dim=-3), scale=ct1.scale * ct2.scale)
    if relin_key is not None:
        out = relinearize(ctx, out, relin_key)
    if rescale_after:
        out = rescale(ctx, out)
    return out


def _match_scales_any(ct1: Ciphertext, ct2: Ciphertext):
    """Operand check for ct×ct multiply: limbs truncate to the common level
    and scales must agree to FLEXIBLEAUTO drift (rtol 0.05); a gross
    mismatch is a caller bug and raises."""
    l = min(ct1.nlimbs, ct2.nlimbs)
    if not np.isclose(ct1.scale, ct2.scale, rtol=0.05):
        raise ValueError(
            f"mult operand scale mismatch: {ct1.scale} vs {ct2.scale} "
            "(rescale/level-adjust the larger operand first)")
    return ct1.data[..., :l, :], ct2.data[..., :l, :], l


def relinearize(ctx: CkksContext, ct: Ciphertext, relin_key: KeySwitchKey) -> Ciphertext:
    if ct.num_components != 3:
        return ct
    l = ct.nlimbs
    q, _, _ = ctx.limb_consts(ctx.q_idx(l), ct.data.device)
    d0, d1 = keyswitch(ctx, ct.data[..., 2, :, :], relin_key, l)
    out = torch.stack([modadd(ct.data[..., 0, :, :], d0, q),
                       modadd(ct.data[..., 1, :, :], d1, q)], dim=-3)
    return Ciphertext(data=out, scale=ct.scale)


# ---------------------------------------------------------------------------
# Galois rotations (eval-domain permutations) + hoisting
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _galois_perm(n: int, g: int) -> np.ndarray:
    """perm with new_eval[k] = old_eval[perm[k]] for the automorphism X→X^g
    acting on bit-reversed eval bins (bin k ↔ root exponent 2·bitrev(k)+1)."""
    rev = bit_reverse_indices(n)
    inv_rev = np.argsort(rev)
    target = ((2 * rev + 1) * g) % (2 * n)
    return inv_rev[(target - 1) // 2]


def rot_to_galois(r: int, n: int) -> int:
    """Slot rotation by r ↔ Galois element 5^r mod 2N (r may be negative)."""
    return pow(5, r % (n // 2), 2 * n)


CONJ_GALOIS = -1  # sentinel: conjugation is g = 2N-1


def automorphism(ctx: CkksContext, data_eval: torch.Tensor, g: int) -> torch.Tensor:
    """X→X^g on eval-domain residues (..., N): one gather on the last axis."""
    if g == CONJ_GALOIS:
        g = 2 * ctx.params.n - 1
    return data_eval.index_select(-1, ctx.galois_perm(g, data_eval.device))


def _rotated(ctx: CkksContext, ct: Ciphertext, g: int, key: KeySwitchKey) -> Ciphertext:
    """Apply X→X^g to both components (one batched permutation), then key
    switch the permuted c1 back to the owner's key."""
    l = ct.nlimbs
    q, _, _ = ctx.limb_consts(ctx.q_idx(l), ct.data.device)
    both = automorphism(ctx, ct.data[..., :l, :], g)
    d0, d1 = keyswitch(ctx, both[..., 1, :, :], key, l)
    return Ciphertext(data=torch.stack([modadd(both[..., 0, :, :], d0, q), d1], dim=-3),
                      scale=ct.scale)


def rotate(ctx: CkksContext, ct: Ciphertext, r: int, rot_key: KeySwitchKey) -> Ciphertext:
    """Rotate packed slots left by r (EvalRotate equivalent)."""
    return _rotated(ctx, ct, rot_to_galois(r, ctx.params.n), rot_key)


def conjugate(ctx: CkksContext, ct: Ciphertext, conj_key: KeySwitchKey) -> Ciphertext:
    return _rotated(ctx, ct, 2 * ctx.params.n - 1, conj_key)


def _split_rows(rot: torch.Tensor, row_counts):
    """Cut the limb axis of a permuted stack back into its digit polys and
    the trailing c0 rows."""
    out, off = [], 0
    for rc in row_counts:
        out.append(rot[..., off : off + rc, :])
        off += rc
    return out, rot[..., off:, :]


def _hoisted_stack(ctx: CkksContext, ct: Ciphertext):
    """Decompose+extend c1 ONCE: the digit polys and c0 in one limb stack,
    so each rotation permutes all of them with one gather."""
    l = ct.nlimbs
    digits = keyswitch_core(ctx, ct.data[..., 1, :, :], l)
    stacked = torch.cat(list(digits) + [ct.data[..., 0, :l, :]], dim=-2)
    return stacked, [d.shape[-2] for d in digits]


def rotate_hoisted(ctx: CkksContext, ct: Ciphertext, rotations: Sequence[int],
                   rot_keys: dict) -> list:
    """Hoisted rotations: decompose+extend ct's c1 ONCE, then per rotation
    permute the extended digits and c0, inner product and ModDown. Valid
    because base extension is coefficient-wise and the automorphism permutes
    coefficients (up to sign): they commute."""
    l = ct.nlimbs
    q, _, _ = ctx.limb_consts(ctx.q_idx(l), ct.data.device)
    stacked, row_counts = _hoisted_stack(ctx, ct)
    out = []
    for r in rotations:
        g = rot_to_galois(r, ctx.params.n)
        dig_rot, c0p = _split_rows(automorphism(ctx, stacked, g), row_counts)
        d0, d1 = keyswitch_apply(ctx, dig_rot, rot_keys[r], l)
        out.append(Ciphertext(data=torch.stack([modadd(c0p, d0, q), d1], dim=-3),
                              scale=ct.scale))
    return out


def rotate_sum_hoisted(ctx: CkksContext, ct: Ciphertext,
                       rotations: Sequence[int], rot_keys: dict) -> Ciphertext:
    """Σ_r rotate(ct, r) with DOUBLE hoisting (Halevi–Shoup): one shared
    decompose+extend and ONE deferred ModDown. Per rotation only the
    permutation and the KSK inner product run; the inner products
    accumulate in the extended basis (the permuted c0 parts in Q). ModDown
    is linear and commutes with the automorphism."""
    l = ct.nlimbs
    dev = ct.data.device
    q_ext, _, _ = ctx.limb_consts(tuple(ctx.q_idx(l)) + ctx.p_idx(), dev)
    q, _, _ = ctx.limb_consts(ctx.q_idx(l), dev)
    stacked, row_counts = _hoisted_stack(ctx, ct)
    acc0 = acc1 = c0_acc = None
    for r in rotations:
        g = rot_to_galois(r, ctx.params.n)
        dig_rot, c0p = _split_rows(automorphism(ctx, stacked, g), row_counts)
        t0, t1 = keyswitch_ip(ctx, dig_rot, rot_keys[r], l)
        if acc0 is None:
            acc0, acc1, c0_acc = t0, t1, c0p
        else:
            acc0 = modadd(acc0, t0, q_ext)
            acc1 = modadd(acc1, t1, q_ext)
            c0_acc = modadd(c0_acc, c0p, q)
    both = _mod_down(ctx, torch.stack([acc0, acc1]), l)
    return Ciphertext(data=torch.stack([modadd(c0_acc, both[0], q), both[1]], dim=-3),
                      scale=ct.scale)
