"""The key switch's digit assembly (``ops/cuda_decompose.py``) on the CPU.

- The plain assembly is ``torch.equal`` to the ``torch.stack`` of the
  per-digit ``torch.cat`` it replaced, and to each row worked out alone
  (own-group rows by a Montgomery product, the rest copied from the
  extension), for l = 1 … 4 on the 60/40/40/20 + 2 × 60 chain, batch shapes
  (), (27,) and (2, 5), c read through the c1 view of a ciphertext or
  contiguous, at the ring's width and a shard's N/D.
- ``keyswitch``, ``re_encrypt``, relinearization, rotation, conjugation and
  the hoisted and sharded rotation paths give the outputs of the assembly
  they replaced, the old per-digit ``torch.cat`` and ``torch.stack``
  patched back in.
- ``keyswitch_ip`` hands the stacked digits to kernel 3's wrapper as they
  are, and the hoisted paths hand it their permuted stack's digit rows.
- On every one of those paths ModDown receives the very tensor kernel 3's
  wrapper returned (the rotation sum: their accumulator), and the outputs
  equal the epilogue the one-layout key switch replaced: the pair cut into
  two views, stacked for ModDown, cut again, c0 added and the components
  restacked (``_old_keyswitch_ip`` … ``_old_with_c0``).
- The wrapper's checks refuse a wrong shape, dtype or device, an odd N and
  a misaligned or oddly strided view.

The kernel is held to the plain version on the card
(``tests/test_torch_decompose_card.py``).
"""

import pytest
import torch

from ppqsflhe_tpu_torch.ckks import eval as ev
from ppqsflhe_tpu_torch.ckks.params import CkksContext, CkksParams
from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
from ppqsflhe_tpu_torch.ckks.types import Ciphertext
from ppqsflhe_tpu_torch.core.modarith import modadd, modmul, shoup_mul
from ppqsflhe_tpu_torch.ops import cuda_decompose
from ppqsflhe_tpu_torch.parallel import mesh as pm
from ppqsflhe_tpu_torch.parallel import sharded_scheme as ss
from ppqsflhe_tpu_torch.utils import graphs

N = 1 << 10
LEADS = [(), (27,), (2, 5)]
WIDTHS = {"ring": N, "shard": N // 8}


def _params():
    """The benchmark's chain at N = 2^10: 60/40/40/20 + 2 × 60, dnum 2."""
    return CkksParams.generate(n=N, mult_depth=2, scale_bits=40, dnum=2, extra_mod_bits=20)


@pytest.fixture(scope="module")
def ctx():
    return CkksContext(_params())


def _residues(moduli, lead, n, seed):
    """int64[*lead, len(moduli), n] below each modulus, with 0 and q − 1 at
    coefficients 0 and 1 of every limb."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.stack([torch.randint(0, q, tuple(lead) + (n,), generator=gen, dtype=torch.int64)
                     for q in moduli], dim=len(lead))
    x[..., 0] = 0
    x[..., 1] = torch.tensor(moduli, dtype=torch.int64).reshape(-1) - 1
    return x


def _operands(ctx, l, lead, n, c1_view, seed):
    """c (the c1 view of a (..., 2, l, n) ciphertext, or a contiguous copy)
    and, per active digit, a random extension to the other limbs, its group
    rows and its constant columns, as ``eval.keyswitch_digits`` hands them."""
    mq = ctx.moduli_qp
    ct = _residues([mq[i] for i in ctx.q_idx(l)], tuple(lead) + (2,), n, seed)
    c = ct[..., 1, :, :] if c1_view else ct[..., 1, :, :].contiguous()
    idx_ext = ctx.q_idx(l) + ctx.p_idx()
    groups, _ = ev._ks_decomp_consts(ctx, l)
    exts = [_residues([mq[i] for i in idx_ext if i not in g], lead, n, seed + 1 + j)
            for j, g in enumerate(groups)]
    return (c, exts, *ev._ks_digit_cols(ctx, l, "cpu"))


def _old_stack(c, exts, spans, w, ws, q):
    """The assembly as the key switch did it before the kernel: a
    ``torch.cat`` a digit around the own-group Shoup product, then a
    ``torch.stack`` of the digits."""
    digits = []
    for e, (lo, hi), wj, wsj, qj in zip(exts, spans, w, ws, q):
        d = shoup_mul(c[..., lo:hi, :], wj, wsj, qj)
        digits.append(torch.cat([e[..., :lo, :], d, e[..., lo:, :]], dim=-2))
    return torch.stack(digits, dim=-3)


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("c1_view", [True, False], ids=["c1_view", "contiguous"])
@pytest.mark.parametrize("lead", LEADS, ids=["x".join(map(str, s)) or "unbatched" for s in LEADS])
@pytest.mark.parametrize("l", [1, 2, 3, 4])
def test_plain_assembly_equals_the_old_stack(ctx, l, lead, c1_view, width):
    n = WIDTHS[width]
    ops = _operands(ctx, l, lead, n, c1_view, 100 * l + n)
    c, exts, spans, w, ws, q = ops
    assert c.is_contiguous() == (not c1_view or not lead)
    got = cuda_decompose.digits(*ops)
    assert got.shape == tuple(lead) + (len(exts), l + ctx.params.num_p, n)
    assert got.is_contiguous()
    assert torch.equal(got, _old_stack(*ops))
    assert torch.equal(cuda_decompose.digits_plain(*ops), got)
    # each row alone: the group's rows c·[Q̂_j⁻¹]_{q_i} by a Montgomery
    # product (0 ↦ 0, q − 1 ↦ q − w), the others the extension's rows
    for j, (e, (lo, hi)) in enumerate(zip(exts, spans)):
        qi, qinv, r2 = ctx.limb_consts(range(lo, hi), "cpu")
        own = modmul(c[..., lo:hi, :], w[j].expand(hi - lo, n), qi, qinv, r2)
        assert torch.equal(got[..., j, lo:hi, :], own)
        assert torch.equal(own[..., 0], torch.zeros_like(own[..., 0]))
        assert torch.equal(own[..., 1], (q[j] - w[j]).reshape(-1).expand_as(own[..., 1]))
        assert torch.equal(got[..., j, :lo, :], e[..., :lo, :])
        assert torch.equal(got[..., j, hi:, :], e[..., lo:, :])


@pytest.fixture(scope="module")
def world():
    """A scheme on the chain above, two key pairs, a rekey, relinearization,
    rotation (1, 2) and conjugation keys, and a batch of 3 ciphertexts."""
    sch = CkksScheme(_params(), device="cpu")
    gen = torch.Generator().manual_seed(25)
    sk1, pk1 = sch.keygen(gen)
    sk2, pk2 = sch.keygen(gen)
    L = sch.params.num_q
    data = torch.stack([torch.randint(0, q, (3, 2, N), generator=gen)
                        for q in sch.ctx.moduli_qp[:L]], dim=-2)
    return dict(sch=sch, ct=Ciphertext(data, sch.params.scale),
                rk=sch.rekey_gen(sk1, pk2, gen), relin=sch.relin_key_gen(sk2, gen),
                rots=sch.rotation_key_gen(sk2, [1, 2], gen),
                conj=sch.conjugation_key_gen(sk2, gen))


def _old_keyswitch_digits(ctx, c_eval, nlimbs):
    """The decomposition as it was: a per-digit ``torch.cat``, then the
    ``torch.stack`` of the digits."""
    l = nlimbs
    idx_ext = tuple(ctx.q_idx(l)) + ctx.p_idx()
    groups, consts = ev._ks_decomp_consts(ctx, l)
    c_coeff = ctx.intt(c_eval, ctx.q_idx(l))
    digits = []
    for g, inv, (lo, hi), w, ws, qg in zip(groups, consts,
                                           *ev._ks_digit_cols(ctx, l, c_eval.device)):
        other = tuple(i for i in idx_ext if i not in g)
        ext_eval = ctx.ntt(ev.fused_extend(c_coeff[..., lo:hi, :], ctx.extender(g, other),
                                           pre=inv), other)
        d_eval = shoup_mul(c_eval[..., lo:hi, :], w, ws, qg)
        digits.append(torch.cat([ext_eval[..., :lo, :], d_eval, ext_eval[..., lo:, :]], dim=-2))
    return torch.stack(digits, dim=-3)


def _sharded(w, run):
    """``run`` on the sharded context of a one-rank coef axis."""
    with pm.single_process_group("cpu"):
        sctx = ss.ShardedEvalContext(w["sch"].params, pm.make_mesh({"client": 1, "coef": 1},
                                                                   "cpu"))
        return run(sctx)


PATHS = {
    "keyswitch_l4": lambda w: [ev.keyswitch(w["sch"].ctx, w["ct"].data[..., 1, :, :],
                                            w["rk"], 4)],
    "keyswitch_l1": lambda w: [ev.keyswitch(w["sch"].ctx, w["ct"].data[..., 1, :1, :],
                                            w["rk"], 1)],
    "re_encrypt_l3": lambda w: [ev.re_encrypt(w["sch"].ctx, ev.level_reduce(
        w["sch"].ctx, w["ct"], 3), w["rk"]).data],
    "relinearize": lambda w: [ev.mult(w["sch"].ctx, w["ct"], w["ct"], w["relin"]).data],
    "rotate": lambda w: [ev.rotate(w["sch"].ctx, w["ct"], 1, w["rots"][1]).data],
    "conjugate": lambda w: [ev.conjugate(w["sch"].ctx, w["ct"], w["conj"]).data],
    "rotate_hoisted": lambda w: [o.data for o in ev.rotate_hoisted(w["sch"].ctx, w["ct"],
                                                                   [1, 2], w["rots"])],
    "rotate_sum_hoisted": lambda w: [ev.rotate_sum_hoisted(w["sch"].ctx, w["ct"], [1, 2],
                                                           w["rots"]).data],
    "re_encrypt_sharded": lambda w: _sharded(w, lambda s: [
        ss.re_encrypt_sharded(s, w["ct"], w["rk"]).data]),
    "rotate_sharded": lambda w: _sharded(w, lambda s: [
        ss.rotate_sharded(s, w["ct"], 1, w["rots"][1]).data]),
    "rotate_hoisted_sharded": lambda w: _sharded(w, lambda s: [
        o.data for o in ss.rotate_hoisted_sharded(s, w["ct"], [1, 2], w["rots"])]),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_paths_equal_the_old_assembly(world, monkeypatch, path):
    with graphs.eager():
        got = PATHS[path](world)
        monkeypatch.setattr(ev, "keyswitch_digits", _old_keyswitch_digits)
        want = PATHS[path](world)
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _old_keyswitch_ip(ctx, digits, ksk, nlimbs):
    """The inner product as it was returned: kernel 3's pair cut into a
    tuple of two views."""
    ksk = ev.ksk_to_mont(ctx, ksk)
    sel_ext = tuple(ctx.q_idx(nlimbs)) + ctx.p_idx()
    q, qinv, _ = ctx.limb_consts(sel_ext, digits.device)
    acc = ev.ks_inner_product(digits, ksk.data, torch.tensor(sel_ext), q, qinv)
    return acc[..., 0, :, :], acc[..., 1, :, :]


def _old_mod_down(ctx, acc0, acc1, nlimbs):
    """ModDown as it was fed: both components stacked on a new front axis,
    the result cut back into (d0, d1)."""
    both = ev._mod_down(ctx, torch.stack([acc0, acc1]), nlimbs)
    return both[0], both[1]


def _old_keyswitch_apply(ctx, digits, ksk, nlimbs):
    return _old_mod_down(ctx, *_old_keyswitch_ip(ctx, digits, ksk, nlimbs), nlimbs)


def _old_keyswitch(ctx, c_eval, ksk, nlimbs):
    return _old_keyswitch_apply(ctx, ev.keyswitch_digits(ctx, c_eval, nlimbs), ksk, nlimbs)


def _old_with_c0(ctx, c0, d0, d1):
    """Each caller's epilogue as it was: c0 + d0, then the pair restacked."""
    q, _, _ = ctx.limb_consts(ctx.q_idx(d0.shape[-2]), d0.device)
    return torch.stack([modadd(c0, d0, q), d1], dim=-3)


def _old_rotated(ctx, data, g, key):
    both = ev.automorphism(ctx, data, g)
    return _old_with_c0(ctx, both[..., 0, :, :],
                        *_old_keyswitch(ctx, both[..., 1, :, :], key, data.shape[-2]))


def _old_relinearized(ctx, ct, key):
    """ct × ct, its c2 key-switched, each half of the pair added on its
    own, the two restacked, then the rescale."""
    ct3 = ev.mult(ctx, ct, ct, None, rescale_after=False)
    l, d = ct3.nlimbs, ct3.data
    q, _, _ = ctx.limb_consts(ctx.q_idx(l), d.device)
    d0, d1 = _old_keyswitch(ctx, d[..., 2, :, :], key, l)
    out = torch.stack([modadd(d[..., 0, :, :], d0, q), modadd(d[..., 1, :, :], d1, q)], dim=-3)
    return ev.rescale(ctx, Ciphertext(out, ct3.scale)).data


def _old_hoisted(ctx, ct, rotations, keys):
    stacked, shape = ev._hoisted_stack(ctx, ct)
    out = []
    for r in rotations:
        dig, c0p = ev._split_rows(ev.automorphism(ctx, stacked, ev.rot_to_galois(r, N)), shape)
        out.append(_old_with_c0(ctx, c0p, *_old_keyswitch_apply(ctx, dig, keys[r], ct.nlimbs)))
    return out


def _old_sum_hoisted(ctx, ct, rotations, keys):
    """The rotation sum as it was: the two halves of the inner products
    and the permuted c0 accumulated apart, then stacked for ModDown."""
    l = ct.nlimbs
    q_ext, _, _ = ctx.limb_consts(tuple(ctx.q_idx(l)) + ctx.p_idx(), "cpu")
    q, _, _ = ctx.limb_consts(ctx.q_idx(l), "cpu")
    stacked, shape = ev._hoisted_stack(ctx, ct)
    acc0 = acc1 = c0_acc = None
    for r in rotations:
        dig, c0p = ev._split_rows(ev.automorphism(ctx, stacked, ev.rot_to_galois(r, N)), shape)
        t0, t1 = _old_keyswitch_ip(ctx, dig, keys[r], l)
        if acc0 is None:
            acc0, acc1, c0_acc = t0, t1, c0p
        else:
            acc0, acc1 = modadd(acc0, t0, q_ext), modadd(acc1, t1, q_ext)
            c0_acc = modadd(c0_acc, c0p, q)
    return _old_with_c0(ctx, c0_acc, *_old_mod_down(ctx, acc0, acc1, l))


def _old_hoisted_sharded(s, ct, rotations, keys):
    l = ct.nlimbs
    digits = ss._gather_full(s, ev.keyswitch_digits(s, ct.data[..., 1, :, :], l))
    c0 = ss._gather_full(s, ct.data[..., 0, :l, :])
    out = []
    for r in rotations:
        g = ev.rot_to_galois(r, N)
        d0, d1 = _old_keyswitch_apply(s, ss._perm_local(s, digits, g), keys[r], l)
        out.append(_old_with_c0(s, ss._perm_local(s, c0, g), d0, d1))
    return out


def _old_rotated_sharded(s, data, g, key):
    c0p, c1p = (ss._automorphism_local(s, data[..., i, :, :], g) for i in (0, 1))
    return _old_with_c0(s, c0p, *_old_keyswitch(s, c1p, key, data.shape[-2]))


OLD_PATHS = {
    "keyswitch_l4": lambda w: [torch.stack(_old_keyswitch(
        w["sch"].ctx, w["ct"].data[..., 1, :, :], w["rk"], 4), dim=-3)],
    "keyswitch_l1": lambda w: [torch.stack(_old_keyswitch(
        w["sch"].ctx, w["ct"].data[..., 1, :1, :], w["rk"], 1), dim=-3)],
    "re_encrypt_l3": lambda w: [_old_with_c0(w["sch"].ctx, w["ct"].data[..., 0, :3, :],
                                             *_old_keyswitch(w["sch"].ctx,
                                                             w["ct"].data[..., 1, :3, :],
                                                             w["rk"], 3))],
    "relinearize": lambda w: [_old_relinearized(w["sch"].ctx, w["ct"], w["relin"])],
    "rotate": lambda w: [_old_rotated(w["sch"].ctx, w["ct"].data, ev.rot_to_galois(1, N),
                                      w["rots"][1])],
    "conjugate": lambda w: [_old_rotated(w["sch"].ctx, w["ct"].data, 2 * N - 1, w["conj"])],
    "rotate_hoisted": lambda w: _old_hoisted(w["sch"].ctx, w["ct"], [1, 2], w["rots"]),
    "rotate_sum_hoisted": lambda w: [_old_sum_hoisted(w["sch"].ctx, w["ct"], [1, 2], w["rots"])],
    "re_encrypt_sharded": lambda w: _sharded(w, lambda s: [_old_with_c0(
        s, w["ct"].data[..., 0, :, :], *_old_keyswitch(s, w["ct"].data[..., 1, :, :],
                                                       w["rk"], 4))]),
    "rotate_sharded": lambda w: _sharded(w, lambda s: [_old_rotated_sharded(
        s, w["ct"].data, ev.rot_to_galois(1, N), w["rots"][1])]),
    "rotate_hoisted_sharded": lambda w: _sharded(w, lambda s: _old_hoisted_sharded(
        s, w["ct"], [1, 2], w["rots"])),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_mod_down_takes_kernel_3s_pair_as_is(world, monkeypatch, path):
    """ModDown receives the very tensor kernel 3's wrapper returned (the
    rotation sum: the accumulator of those tensors, (..., 2, l + K, n)),
    and every path's output equals the epilogue it replaced: the pair cut
    into two views, stacked for ModDown, cut again, c0 added and the
    components restacked."""
    inner, mod_down, add = ev.ks_inner_product, ev._mod_down, ev.modadd
    pairs, fed, sums = [], [], []
    monkeypatch.setattr(ev, "ks_inner_product", lambda *a: pairs.append(inner(*a)) or pairs[-1])
    monkeypatch.setattr(ev, "_mod_down", lambda c, x, l: fed.append(x) or mod_down(c, x, l))
    monkeypatch.setattr(ev, "modadd", lambda *a: sums.append(add(*a)) or sums[-1])
    with graphs.eager():
        got = PATHS[path](world)
    monkeypatch.undo()
    assert pairs and fed
    if path == "rotate_sum_hoisted":
        lk = len(world["sch"].ctx.moduli_qp)
        assert len(fed) == 1 and fed[0].shape == (3, 2, lk, N)
        assert any(fed[0] is s for s in sums)
    else:
        assert len(fed) == len(pairs) and all(x is p for x, p in zip(fed, pairs))
    with graphs.eager():
        want = OLD_PATHS[path](world)
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("l", [4, 3, 2, 1])
def test_keyswitch_ip_passes_the_stack_as_is(world, monkeypatch, l):
    """The stack goes to kernel 3's wrapper as it is, with no copy."""
    ctx = world["sch"].ctx
    stack = ev.keyswitch_digits(ctx, world["ct"].data[..., 1, :l, :], l)
    seen, inner = [], ev.ks_inner_product
    monkeypatch.setattr(ev, "ks_inner_product", lambda d, *a: seen.append(d) or inner(d, *a))
    ev.keyswitch_ip(ctx, stack, world["rk"], l)
    assert len(seen) == 1 and seen[0] is stack


@pytest.mark.parametrize("l", [4, 3, 2, 1])
def test_hoisted_stack_holds_the_digits_then_c0(world, l):
    """The hoisted paths' limb stack is the digits' rows, digit by digit,
    then c0's; cut back, its digit rows are the stack of
    ``keyswitch_digits``."""
    ctx, ct = world["sch"].ctx, ev.level_reduce(world["sch"].ctx, world["ct"], l)
    stacked, shape = ev._hoisted_stack(ctx, ct)
    digits = ev.keyswitch_digits(ctx, ct.data[..., 1, :, :], l)
    assert tuple(shape) == digits.shape[-3:-1]
    dig, c0 = ev._split_rows(stacked, shape)
    assert torch.equal(dig, digits)
    assert torch.equal(c0, ct.data[..., 0, :, :])


def _bad_cases(ctx):
    """(name, operands) the wrapper refuses."""
    c, exts, spans, w, ws, q = _operands(ctx, 3, (4,), 64, True, 7)
    wide = _residues(ctx.moduli_qp[:3], (4,), 65, 8)        # rows of 65: odd strides
    wider = _residues(ctx.moduli_qp[:3], (4,), 66, 9)       # a view one word in: 8-byte aligned
    return {
        "shape": (c, [exts[0][..., 1:, :]] + exts[1:], spans, w, ws, q),
        "batch": (c[:3], exts, spans, w, ws, q),
        "dtype": (c.to(torch.int32), exts, spans, w, ws, q),
        "ext_dtype": (c, [exts[0].to(torch.int32)] + exts[1:], spans, w, ws, q),
        "device": (c, [exts[0].to("meta")] + exts[1:], spans, w, ws, q),
        "constants": (c, exts, spans, [w[0][:1]] + w[1:], ws, q),
        "digits": (c, exts[:1], spans, w, ws, q),
        "odd_n": (c[..., :63], [e[..., :63] for e in exts], spans, w, ws, q),
        "misaligned": (wider[..., 1:65], exts, spans, w, ws, q),
        "odd_strides": (wide[..., :64], exts, spans, w, ws, q),
    }


@pytest.mark.parametrize("case", ["shape", "batch", "dtype", "ext_dtype", "device", "constants",
                                  "digits", "odd_n", "misaligned", "odd_strides"])
def test_wrapper_refuses(ctx, case):
    with pytest.raises(ValueError):
        cuda_decompose.digits(*_bad_cases(ctx)[case])
