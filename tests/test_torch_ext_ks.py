"""Base extension, KSK inner product and hybrid key switching of the port
against the JAX package: ``BaseExtender.extend``, the Pallas kernels
``fused_extend`` and ``ks_inner_product`` in interpret mode, and
``eval.keyswitch`` at full level (two digits) and one level down (one
digit). Inputs are numpy-seeded and fed to both; every comparison is
bit-exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppqsflhe_tpu.ckks import eval as jev
from ppqsflhe_tpu.ckks.params import CkksParams as JaxParams
from ppqsflhe_tpu.ckks.params import CkksContext as JaxContext
from ppqsflhe_tpu.ckks.types import KeySwitchKey as JaxKsk
from ppqsflhe_tpu.core.modarith import shoup_mul as jax_shoup_mul
from ppqsflhe_tpu.core.rns import BaseExtender as JaxExtender
from ppqsflhe_tpu.ops.pallas_ext import fused_extend as jax_fused_extend
from ppqsflhe_tpu.ops.pallas_ks import ks_inner_product as jax_ks_inner_product
from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.ckks import eval as ev
from ppqsflhe_tpu_torch.ckks.params import CkksContext
from ppqsflhe_tpu_torch.core import primes
from ppqsflhe_tpu_torch.core.rns import BaseExtender
from ppqsflhe_tpu_torch.ops.cuda_ext import fused_extend
from ppqsflhe_tpu_torch.ops.cuda_ks import ks_inner_product, ks_inner_product_plain

N = 1 << 10


@pytest.fixture(scope="module")
def contexts():
    jp = JaxParams.generate(n=N, mult_depth=2, scale_bits=40, dnum=2,
                            ntt_backend="fourstep", ntt_impl="mxu")
    return JaxContext(jp), CkksContext(convert.params(dataclasses.asdict(jp)))


def _residues(moduli, lead, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, size=lead + (N,), dtype=np.uint64) for q in moduli],
                    axis=len(lead))


# (src limbs, dst limbs, fold the digit constant) as the round uses them:
# full-level digits 0 and 1, and the ModDown extension P → Q
EXT_CASES = [((0, 1), (2, 3, 4), True), ((2,), (0, 1, 3, 4), True), ((3, 4), (0, 1, 2), False),
             ((0, 1), (3, 4), True)]


@pytest.mark.parametrize("src,dst,fold", EXT_CASES, ids=["d0", "d1", "moddown", "lazy_d0"])
def test_extend_matches_reference(contexts, src, dst, fold):
    jctx, ctx = contexts
    mq = ctx.moduli_qp
    x = _residues([mq[i] for i in src], (3,), seed=len(src) + 10 * len(dst))
    pre = [primes.mod_inverse(7 + i, mq[i]) for i in src] if fold else None
    jext = JaxExtender([mq[i] for i in src], [mq[i] for i in dst])
    xj = jnp.asarray(x)
    if fold:
        # the JAX package's non-fused path: multiply by pre, then extend
        q = np.array([mq[i] for i in src], np.uint64).reshape(-1, 1)
        w = np.array(pre, np.uint64).reshape(-1, 1)
        ws = np.array([primes.shoup_precompute(v, mq[i]) for v, i in zip(pre, src)],
                      np.uint64).reshape(-1, 1)
        want = np.asarray(jext.extend(jax_shoup_mul(xj, w, ws, q)))
    else:
        want = np.asarray(jext.extend(xj))
    want_fused = np.asarray(jax_fused_extend(xj, jext, pre=pre, interpret=True))
    np.testing.assert_array_equal(want_fused, want)
    ext = BaseExtender([mq[i] for i in src], [mq[i] for i in dst])
    got = convert.residues_np(ext.extend(convert.residues(x, "cpu"), pre))
    np.testing.assert_array_equal(got, want)
    # the kernel wrapper's CPU route is the plain version
    np.testing.assert_array_equal(
        convert.residues_np(fused_extend(convert.residues(x, "cpu"), ext, pre)), want)


@pytest.mark.parametrize("limbs", [(0, 1, 2, 3, 4), (0, 1, 3, 4)], ids=["l3", "l2"])
def test_ks_inner_product_matches_pallas_interpret(contexts, limbs):
    """Two digits, the key shared across a batch of 2; a limb subset reads
    the right rows of the full key."""
    _, ctx = contexts
    mq = ctx.moduli_qp
    sel = [mq[i] for i in limbs]
    q, qinv, _ = ctx.limb_consts(limbs, "cpu")
    limb_map = torch.as_tensor(limbs)
    dig = _residues(sel, (2, 2), seed=1)                       # (B, nd, LK, N)
    key = _residues(mq, (2, 2), seed=2)                        # (nd, 2, LKT, N), mont form
    qp = np.array([[q & 0xFFFFFFFF, q >> 32] for q in sel], np.uint32)
    ip = np.array([[v & 0xFFFFFFFF, v >> 32] for v in map(primes.mont_qinv_neg, sel)],
                  np.uint32)
    want = np.asarray(jax_ks_inner_product(jnp.asarray(dig), jnp.asarray(key[:, :, list(limbs)]),
                                           qp, ip, interpret=True))
    dig_t, key_t = convert.residues(dig, "cpu"), convert.residues(key, "cpu")
    got = ks_inner_product_plain(dig_t, key_t, limb_map, q, qinv)
    np.testing.assert_array_equal(convert.residues_np(got), want)
    got_w = ks_inner_product(dig_t, key_t, limb_map, q, qinv)
    np.testing.assert_array_equal(convert.residues_np(got_w), want)


@pytest.mark.parametrize("nlimbs", [3, 2], ids=["l3_two_digits", "l2_one_digit"])
def test_keyswitch_matches_reference(contexts, nlimbs):
    """ev.keyswitch over a batch of 2 polys against the JAX package's, per
    poly, with a Montgomery-form key (the round's rekey form)."""
    jctx, ctx = contexts
    mq = ctx.moduli_qp
    c = _residues(mq[:nlimbs], (2,), seed=20 + nlimbs)
    key = _residues(mq, (2, 2), seed=30)
    jkey = jev.ksk_to_mont(jctx, JaxKsk(data=jnp.asarray(key)))
    pkey = ev.ksk_to_mont(ctx, convert.keyswitch_key(key, device="cpu"))
    np.testing.assert_array_equal(convert.residues_np(pkey.data), np.asarray(jkey.data))
    one = jax.jit(lambda ci: jnp.stack(jev.keyswitch(jctx, ci, jkey, nlimbs)))
    want = np.stack([np.asarray(one(jnp.asarray(ci))) for ci in c])   # (B, 2, l, N)
    pair = ev.keyswitch(ctx, convert.residues(c, "cpu"), pkey, nlimbs)
    assert pair.shape == (2, 2, nlimbs, ctx.params.n)
    np.testing.assert_array_equal(convert.residues_np(pair), want)


@pytest.mark.parametrize("nlimbs", [3, 2, 1], ids=["two_digits", "one_digit_l2", "one_digit_l1"])
def test_keyswitch_ip_goes_through_kernel_3_wrapper(contexts, monkeypatch, nlimbs):
    """keyswitch_ip calls the kernel-3 wrapper ``ks_inner_product`` once at
    every digit count, one digit included (the lazy-4 schedule's switches),
    and gives the plain version's residues (the wrapper's CPU route)."""
    _, ctx = contexts
    mq = ctx.moduli_qp
    calls = []

    def counted(*args):
        calls.append(args[0].shape[-3])
        return ks_inner_product(*args)

    monkeypatch.setattr(ev, "ks_inner_product", counted)
    c = convert.residues(_residues(mq[:nlimbs], (2,), seed=50 + nlimbs), "cpu")
    key = ev.ksk_to_mont(ctx, convert.keyswitch_key(_residues(mq, (2, 2), seed=51), device="cpu"))
    digits = ev.keyswitch_digits(ctx, c, nlimbs)
    acc = ev.keyswitch_ip(ctx, digits, key, nlimbs)
    nd = digits.shape[-3]
    assert calls == [nd] and nd == (2 if nlimbs == 3 else 1)
    sel_ext = tuple(ctx.q_idx(nlimbs)) + ctx.p_idx()
    q, qinv, _ = ctx.limb_consts(sel_ext, "cpu")
    want = ks_inner_product_plain(digits, key.data, torch.as_tensor(sel_ext), q, qinv)
    assert acc.shape == (2, 2, len(sel_ext), ctx.params.n) and torch.equal(acc, want)


def test_mult_scalar_rescale_matches_reference(contexts):
    """mult_scalar(0.5) with its rescale (the full-level FedAvg ÷2) over a
    batch of 2 ciphertexts, against the JAX package's per ciphertext."""
    from ppqsflhe_tpu.ckks.types import Ciphertext as JaxCt
    from ppqsflhe_tpu_torch.ckks.types import Ciphertext

    jctx, ctx = contexts
    data = _residues(ctx.moduli_qp[:3], (2, 2), seed=40)         # (B, 2, l, N)
    one = jax.jit(lambda d: jev.mult_scalar(jctx, JaxCt(d, 2.0**40), 0.5).data)
    want = np.stack([np.asarray(one(jnp.asarray(d))) for d in data])
    got = ev.mult_scalar(ctx, Ciphertext(convert.residues(data, "cpu"), 2.0**40), 0.5)
    np.testing.assert_array_equal(convert.residues_np(got.data), want)
    assert got.scale == 2.0**40 and got.nlimbs == 2


def test_crt_helpers_match_reference(contexts):
    from ppqsflhe_tpu.core import rns as jrns
    from ppqsflhe_tpu_torch.core import rns

    _, ctx = contexts
    moduli = ctx.moduli_qp[:3]
    vals = [0, 1, -1, 2**100 + 7, -(2**90) - 3, 12345678901234567890]
    res = rns.decompose_int(vals, moduli)
    np.testing.assert_array_equal(res, jrns.decompose_int(vals, moduli))
    assert list(rns.compose_centered(res, moduli)) == vals
    assert list(rns.compose_int(res, moduli)) == list(jrns.compose_int(res, moduli))
