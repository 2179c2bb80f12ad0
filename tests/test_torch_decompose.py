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
from ppqsflhe_tpu_torch.core.modarith import modmul, shoup_mul
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
    "keyswitch_l4": lambda w: list(ev.keyswitch(w["sch"].ctx, w["ct"].data[..., 1, :, :],
                                                w["rk"], 4)),
    "keyswitch_l1": lambda w: list(ev.keyswitch(w["sch"].ctx, w["ct"].data[..., 1, :1, :],
                                                w["rk"], 1)),
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
