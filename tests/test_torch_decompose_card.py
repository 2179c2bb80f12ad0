"""On the card (skipped without one): the key switch's digit assembly
(``csrc/decompose.cu``) is ``torch.equal`` to its plain version at the
benchmark cells' shapes, reading c in place through the c1 view
``ct.data[..., 1, :, :]``; it refuses what it does not take; a CUDA-graph
capture replays equal to its eager call, and ``launches`` counts eager
calls and captures, not replays; ptxas reports no register spill; and an
eager pairwise server round takes it once a digit and gives the round of
the plain assembly bit for bit.

This file imports no JAX: run it on the card's machine, which has none,
with ``python3 -m pytest --noconftest -m card tests/test_torch_decompose_card.py``.
"""

import re
import subprocess

import pytest
import torch

from ppqsflhe_tpu_torch.bench import server_round as sr
from ppqsflhe_tpu_torch.ckks import eval as ev
from ppqsflhe_tpu_torch.ckks.params import CkksContext, CkksParams
from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
from ppqsflhe_tpu_torch.fl.api import server_round
from ppqsflhe_tpu_torch.ops import cuda_decompose, cuda_lib
from ppqsflhe_tpu_torch.utils import graphs

# (lead, l, width): the pairwise (27) and multikey (154) key switches at the
# cells' levels, N = 2^16's PREs (pairwise-n16), a shard's width N/D = 4096,
# a small ring, an unbatched and a two-axis batch
SHAPES = ([((27,), l, 1 << 14) for l in (2, 3, 4)] + [((154,), l, 1 << 14) for l in (2, 3, 4)]
          + [((27,), l, 1 << 16) for l in (3, 4)]
          + [((27,), 3, 4096), ((27,), 3, 1 << 7), ((), 4, 1 << 14), ((2, 5), 3, 1 << 14)])


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def ctx(card):
    """The benchmark's chain, 60/40/40/20 + 2 × 60: its constants only (the
    same residues at every ring: the shapes below take their width from c)."""
    return CkksContext(CkksParams.generate(n=1 << 14, mult_depth=2, scale_bits=40, dnum=2,
                                           extra_mod_bits=20))


def _residues(moduli, lead, n, seed, device):
    """int64[*lead, len(moduli), n] below each modulus, with 0 and q − 1 at
    coefficients 0 and 1 of every limb."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.stack([torch.randint(0, q, lead + (n,), generator=gen, dtype=torch.int64)
                     for q in moduli], dim=len(lead))
    x[..., 0] = 0
    x[..., 1] = torch.tensor(moduli, dtype=torch.int64).reshape(-1) - 1
    return x.to(device)


def _operands(ctx, lead, l, n, device):
    """c, the c1 view of a (*lead, 2, l, n) ciphertext, and per active digit
    a random extension, its group rows and the context's constant columns."""
    mq = ctx.moduli_qp
    ct = _residues([mq[i] for i in ctx.q_idx(l)], lead + (2,), n, 10 * l + n, device)
    idx_ext = ctx.q_idx(l) + ctx.p_idx()
    groups, _ = ev._ks_decomp_consts(ctx, l)
    exts = [_residues([mq[i] for i in idx_ext if i not in g], lead, n, 10 * l + n + 1 + j,
                      device) for j, g in enumerate(groups)]
    return (ct[..., 1, :, :], exts, *ev._ks_digit_cols(ctx, l, device))


@pytest.mark.card
@pytest.mark.parametrize("lead,l,n", SHAPES,
                         ids=[f"{'x'.join(map(str, s)) or 'unbatched'}-l{l}-n{n}"
                              for s, l, n in SHAPES])
def test_kernel_equals_plain_on_the_c1_view(card, ctx, lead, l, n):
    ops = _operands(ctx, lead, l, n, card)
    c = ops[0]
    assert not c.is_contiguous() or not lead
    before = cuda_decompose.launches
    got = cuda_decompose.digits(*ops)
    torch.cuda.synchronize()
    assert cuda_decompose.launches == before + len(ops[1])
    assert torch.equal(got, cuda_decompose.digits_plain(*ops))
    assert torch.equal(got, cuda_decompose.digits(c.contiguous(), *ops[1:]))


@pytest.mark.card
def test_kernel_refuses_what_it_does_not_take(card, ctx):
    c, exts, spans, w, ws, q = _operands(ctx, (4,), 3, 256, card)
    wide = _residues(ctx.moduli_qp[:3], (4,), 258, 1, card)
    bad = [(c[..., :255], [e[..., :255] for e in exts], spans, w, ws, q),   # odd N
           (wide[..., 1:257], exts, spans, w, ws, q),                      # 8-byte aligned
           (c, [exts[0][..., 1:, :]] + exts[1:], spans, w, ws, q),         # extension rows
           (c, [exts[0].cpu()] + exts[1:], spans, w, ws, q),               # off the card
           (c, exts, spans, [w[0].cpu()] + w[1:], ws, q),                  # a constant off it
           (c.to(torch.int32), exts, spans, w, ws, q)]                     # dtype
    for args in bad:
        with pytest.raises(ValueError):
            cuda_decompose.digits(*args)


@pytest.mark.card
def test_graph_replays_equal_the_eager_call(card, ctx):
    """A capture counts its launches once; replays count none and write
    the eager call's digits into the graph's output."""
    ops = _operands(ctx, (154,), 3, 1 << 14, card)
    nd = len(ops[1])
    want = cuda_decompose.digits(*ops)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cuda_decompose.digits(*ops)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    before = cuda_decompose.launches
    with torch.cuda.graph(g):
        out = cuda_decompose.digits(*ops)
    assert cuda_decompose.launches == before + nd
    out.fill_(-1)
    for _ in range(3):
        g.replay()
    torch.cuda.synchronize()
    assert cuda_decompose.launches == before + nd
    assert torch.equal(out, want)


@pytest.mark.card
def test_no_register_spill(card, tmp_path):
    """ptxas -v on csrc/decompose.cu: the kernel spills nothing."""
    r = subprocess.run([cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                        str(cuda_lib.CSRC / "decompose.cu"), "-o", str(tmp_path / "d.o")],
                       capture_output=True, text=True, check=True)
    report = r.stderr
    assert "decompose_kernel" in report
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", report)
    assert spills and all(s == ("0", "0") for s in spills), report
    print(report)


@pytest.fixture(scope="module")
def pairwise(card):
    sch = CkksScheme(sr.params(), device=card)
    return sch, sr.world(sch, sr.payload(sch.encoder.slots))


@pytest.mark.card
@pytest.mark.parametrize("lazy", [4, 0])
def test_eager_round_takes_the_kernel(card, pairwise, monkeypatch, lazy):
    """Every decomposition of a pairwise round goes through the kernel, one
    launch a digit, and the round equals the one with the plain assembly."""
    sch, w = pairwise
    digits = []
    inner = cuda_decompose.digits
    monkeypatch.setattr(ev, "decompose_digits", lambda c, exts, *a: digits.append(len(exts))
                        or inner(c, exts, *a))
    with graphs.eager():
        before = cuda_decompose.launches
        got = server_round(sch, w.ct1, w.ct2, w.rk12, w.rk21, lazy)
        torch.cuda.synchronize()
        assert len(digits) == 2 and cuda_decompose.launches - before == sum(digits)
        monkeypatch.setattr(ev, "decompose_digits", cuda_decompose.digits_plain)
        want = server_round(sch, w.ct1, w.ct2, w.rk12, w.rk21, lazy)
    assert all(torch.equal(a.data, b.data) and a.scale == b.scale for a, b in zip(got, want))
