"""Homomorphic evaluation: the subset the server's aggregation round runs.

Twin of :mod:`ppqsflhe_tpu.ckks.eval` (add, mult_scalar, rescale,
level_reduce, and HYBRID key switching with PRE rekey generation). The KSK
for digit j encrypts P·t·Q̂_j with Q̂_j = Q_full/D_j the full-basis CRT
cofactor; the level-l decomposition multiplies the ciphertext's group-j
residues by [Q̂_j^{-1}]_{q_i} before base extension, so one KSK serves every
level. Leading batch dimensions ride through every function (the JAX
package vmapped instead).

Kernel routing follows the tensor's device: the NTTs go through
``ctx.ntt``/``ctx.intt`` (kernel 1), the base extensions through
:func:`..ops.cuda_ext.fused_extend` (kernel 2), and the KSK inner product
through :func:`..ops.cuda_ks.ks_inner_product` (kernel 3) when there are two
or more digits — the JAX package's gate (``ppqsflhe_tpu/ckks/eval.py:274``);
one digit runs its plain torch version on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import primes, sampling
from ..core.modarith import modadd, modmul, modsub, mont_mul, shoup_mul, shoup_mul_wide
from ..ops.cuda_ext import fused_extend
from ..ops.cuda_ks import ks_inner_product, ks_inner_product_plain
from .params import CkksContext
from .types import Ciphertext, KeySwitchKey, PublicKey


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


def mult_scalar(ctx: CkksContext, ct: Ciphertext, c: float) -> Ciphertext:
    """EvalMult(ct, double) then rescale: the constant encodes exactly at
    scale q_last, so the ciphertext scale comes out unchanged (FLEXIBLEAUTO,
    the JAX package's default ``rescale_after=True``)."""
    l = ct.nlimbs
    idx = ctx.q_idx(l)
    dev = ct.data.device
    q, _, _ = ctx.limb_consts(idx, dev)
    enc_scale = float(ctx.moduli_qp[l - 1])
    m = int(round(c * enc_scale))
    res = [m % ctx.moduli_qp[i] for i in idx]
    w = ctx.consts(("scalar", m, idx), lambda: res, dev)
    ws = ctx.consts(("scalar_sh", m, idx), lambda: (
        primes.shoup_precompute(r, ctx.moduli_qp[i]) for r, i in zip(res, idx)), dev)
    return rescale(ctx, Ciphertext(shoup_mul(ct.data, w, ws, q), scale=ct.scale * enc_scale))


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
        digits.append(torch.cat([ext_eval[..., :lo, :], d_eval, ext_eval[..., lo:, :]], dim=-2))
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
    ksk = ksk_to_mont(ctx, ksk)
    sel_ext = tuple(ctx.q_idx(nlimbs)) + ctx.p_idx()
    dev = digits[0].device
    q, qinv, _ = ctx.limb_consts(sel_ext, dev)
    sel = ctx.consts(("limb_map", sel_ext), lambda: sel_ext, dev)
    fn = ks_inner_product if len(digits) >= 2 else ks_inner_product_plain
    acc = fn(torch.stack(digits, dim=-3), ksk.data, sel, q, qinv)
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


# ---------------------------------------------------------------------------
# Key-switch key generation (PRE: from a public key)
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


def keyswitch_key_gen(ctx: CkksContext, target_eval_q: torch.Tensor,
                      gen: torch.Generator, pk_to: PublicKey) -> KeySwitchKey:
    """KSK keying ``target_eval_q`` (int64[L, n], eval domain) to the owner
    of ``pk_to``: each digit row is a pk-encryption of P·Q̂_j·target over QP
    (the INDCPA PRE rekey, ``ppqsflhe_tpu`` pk_to path)."""
    from .rlwe import _poly_mul, _signed_to_eval

    n = ctx.params.n
    L = ctx.params.num_q
    K = ctx.params.num_p
    dev = target_eval_q.device
    all_idx = tuple(range(L + K))
    q_all, _, _ = ctx.limb_consts(all_idx, dev)
    q_l, qinv_l, r2_l = ctx.limb_consts(range(L), dev)
    rows = []
    for j, f in enumerate(_ks_target_factors(ctx)):
        fj = ctx.consts(("ks_factor", j), lambda: f, dev)
        m_q = modmul(target_eval_q, fj, q_l, qinv_l, r2_l)
        m = torch.cat([m_q, torch.zeros((K, n), dtype=torch.int64, device=dev)])
        u = _signed_to_eval(ctx, sampling.ternary(gen, n, dev), all_idx)
        e0 = _signed_to_eval(ctx, sampling.discrete_gaussian(gen, n, ctx.params.sigma, dev),
                             all_idx)
        e1 = _signed_to_eval(ctx, sampling.discrete_gaussian(gen, n, ctx.params.sigma, dev),
                             all_idx)
        b = modadd(modadd(_poly_mul(ctx, pk_to.data[0], u, all_idx), e0, q_all), m, q_all)
        a = modadd(_poly_mul(ctx, pk_to.data[1], u, all_idx), e1, q_all)
        rows.append(torch.stack([b, a]))
    return KeySwitchKey(data=torch.stack(rows))

