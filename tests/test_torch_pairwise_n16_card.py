"""On the card (skipped without one): the key switch's kernels at the
shapes of the full pairwise round with the ring raised to N = 2^16, on the
60/40/40/20 + 2 × 60 chain (``tests/test_torch_pairwise_n16.py``), each
``torch.equal`` to its plain version: kernel 2 (``base_extend``) at every
extension of the full round's two PREs (each digit's, its constant
folded in, over 27 polys; ModDown's P → Q_l over 54), kernel 3
(``ks_ip``) over both digits at l = 4 and 3, and kernel 8 (ModDown's tail)
over 54 polys at l = 4 and 3, reading ``c`` in place from ``c_ext``.

This file imports no JAX: run it on the card's machine with
``python3 -m pytest --noconftest -m card tests/test_torch_pairwise_n16_card.py``.
"""

import pytest
import torch

from ppqsflhe_tpu_torch.ckks.eval import _ks_decomp_consts
from ppqsflhe_tpu_torch.ckks.params import CkksContext, CkksParams
from ppqsflhe_tpu_torch.ops import cuda_ext, cuda_ks, cuda_moddown

N = 1 << 16
B = 27               # ciphertexts a client in the GRU payload
LEVELS = (4, 3)      # the full round's PRE in and PRE back


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def ctx(card):
    """The round's chain: its constants and extenders only."""
    return CkksContext(CkksParams.generate(n=N, mult_depth=2, scale_bits=40, dnum=2,
                                           slots=8192, extra_mod_bits=20))


def _residues(moduli, lead, seed, device):
    """int64[*lead, len(moduli), N] below each modulus, with 0 and q − 1 at
    coefficients 0 and 1 of every limb."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.stack([torch.randint(0, q, lead + (N,), generator=gen, dtype=torch.int64)
                     for q in moduli], dim=len(lead))
    x[..., 0] = 0
    x[..., 1] = torch.tensor(moduli, dtype=torch.int64).reshape(-1) - 1
    return x.to(device)


def _extensions(ctx, l):
    """(source, destination, constant, lead) of each base extension a PRE
    at level l runs."""
    idx_ext = ctx.q_idx(l) + ctx.p_idx()
    groups, consts = _ks_decomp_consts(ctx, l)
    out = [(tuple(g), tuple(i for i in idx_ext if i not in g), pre, (B,))
           for g, pre in zip(groups, consts)]
    return out + [(ctx.p_idx(), ctx.q_idx(l), None, (2, B))]


CASES = [(l, k) for l in LEVELS for k in range(3)]


@pytest.mark.card
@pytest.mark.parametrize("l,k", CASES, ids=[f"l{l}-ext{k}" for l, k in CASES])
def test_base_extend_equals_plain(card, ctx, l, k):
    exts = _extensions(ctx, l)
    assert len(exts) == 3                  # two digits' and ModDown's
    src, dst, pre, lead = exts[k]
    ext = ctx.extender(src, dst)
    x = _residues([ctx.moduli_qp[i] for i in src], lead, 100 * l + k, card)
    before = cuda_ext.launches
    got = cuda_ext.fused_extend(x, ext, pre)
    torch.cuda.synchronize()
    assert cuda_ext.launches > before
    assert got.shape == lead + (len(dst), N)
    assert torch.equal(got, ext.extend(x, pre))


@pytest.mark.card
@pytest.mark.parametrize("l", LEVELS)
def test_ks_ip_equals_plain(card, ctx, l):
    limbs = ctx.q_idx(l) + ctx.p_idx()
    mq = ctx.moduli_qp
    nd = len(_ks_decomp_consts(ctx, l)[0])
    q, qinv, _ = ctx.limb_consts(limbs, card)
    sel = ctx.consts(("limb_map", limbs), lambda: limbs, card)
    digits = _residues([mq[i] for i in limbs], (B, nd), 10 + l, card)
    key = _residues(mq, (len(ctx.digit_groups), 2), 20 + l, card)    # a key in Montgomery form
    before = cuda_ks.launches
    got = cuda_ks.ks_inner_product(digits, key, sel, q, qinv)
    torch.cuda.synchronize()
    assert cuda_ks.launches == before + 1 and nd == 2
    assert torch.equal(got, cuda_ks.ks_inner_product_plain(digits, key, sel, q, qinv))


@pytest.mark.card
@pytest.mark.parametrize("l", LEVELS)
def test_moddown_tail_equals_plain(card, ctx, l):
    mq, idx = ctx.moduli_qp, ctx.q_idx(l)
    c_ext = _residues([mq[i] for i in idx + ctx.p_idx()], (2, B), 30 + l, card)
    e = _residues([mq[i] for i in idx], (2, B), 40 + l, card)
    q = ctx.limb_consts(idx, card)[0]
    pinv, pinv_sh = ctx.moddown_consts(l, card)
    c = c_ext[..., :l, :]
    before = cuda_moddown.launches
    got = cuda_moddown.moddown_tail(c, e, q, pinv, pinv_sh)
    torch.cuda.synchronize()
    assert cuda_moddown.launches == before + 1
    assert torch.equal(got, cuda_moddown.moddown_tail_plain(c, e, q, pinv, pinv_sh))
