"""Kernels 1 and 1b as Shoup butterflies (``ops/cuda_mxu_ntt.py``): the plain
stages against the digit-matmul plain transforms (``ops/mxu_ntt.py``) and the
JAX package's fused ``PallasMxuNtt`` in interpret mode, both twiddle kinds;
the CUDA kernels' thread schedule, modelled step for step on the CPU, against
the plain stages at every m the kernels take; and the launcher's refusals.
Exact integer residues, tolerance 0 (stage 1: ≡ mod q, < 2q), on a
60/40/40/20-bit chain."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_streamed_ntt import _high, _labels, _low

from ppqsflhe_tpu.ops import pallas_mxu_ntt as PMX
from ppqsflhe_tpu_torch.core import primes
from ppqsflhe_tpu_torch.core.modarith import mont_mul_lazy, shoup_mul, shoup_mul_lazy, u64_to_i64
from ppqsflhe_tpu_torch.ops import cuda_lib, cuda_mxu_ntt, mxu_ntt
from ppqsflhe_tpu_torch.ops.cuda_mxu_ntt import CudaMxuNtt, stage1_plain, stage2_plain


def _chain(n):
    return ([primes.first_prime_down(60, 2 * n)] + primes.prime_chain(40, 2, 2 * n)
            + [primes.next_prime_up(1 << 19, 2 * n)])


def _t(a):
    return torch.from_numpy(np.array(a, np.uint64, order="C").view(np.int64))


def _u(t):
    return t.numpy().view(np.uint64)


def _lazy_inputs(moduli, sel, shape, seed):
    """Residues < 4q per limb (a transform's input contract), (B, L) + shape."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, 4 * moduli[i], size=shape, dtype=np.uint64)
                     for i in sel], axis=1)


_RUNNERS = {}


def _runner(n):
    """(moduli, the port's runner), built once per n."""
    if n not in _RUNNERS:
        moduli = _chain(n)
        _RUNNERS[n] = moduli, CudaMxuNtt(n, moduli, [primes.root_of_unity(2 * n, q)
                                                     for q in moduli])
    return _RUNNERS[n]


def _digit_stage1(x, t, forward, mont):
    """The digit-matmul first stage of one limb (``mxu_ntt_limb``'s, no
    transpose): x (B, m1, m2) < 4q → < 2q."""
    a = mxu_ntt._mat(t, "a1" if forward else "a2i", x.device)
    y = mxu_ntt._stage(x, a, t)
    if mont:
        return mxu_ntt._twiddle_mont(y, t.t1m if forward else t.t1im, t)
    return mxu_ntt._twiddle(y, t.t1 if forward else t.t1i, t.q)


@pytest.mark.parametrize("n", [512, 2048])
@pytest.mark.parametrize("mont", [False, True], ids=["shoup", "mont"])
def test_plain_stages_match_digit_and_pallas_interpret(monkeypatch, n, mont):
    """Stage 1 then stage 2 (the plain versions of kernel 1, or 1b with the
    Montgomery twiddle) on inputs < 4q equal the digit plain transforms and
    ``PallasMxuNtt`` in interpret mode (every group forced onto the same
    twiddle), forward and inverse; stage 1 alone is < 2q and ≡ the digit
    stage mod q, and stage 2 of the digit stage's representative gives the
    same canonical output."""
    moduli, runner = _runner(n)
    psis = [t.psi for t in runner.tabs]
    if mont:
        monkeypatch.setattr(PMX.PallasMxuNtt, "_group_fits",
                            lambda self, nd, twiddle_planes=4: twiddle_planes == 2)
    pm = PMX.PallasMxuNtt(n, moduli, psis)
    sel = list(range(len(moduli)))
    chain = runner.tables.streamed
    tabs = [chain.limb(i) for i in sel]
    x = _lazy_inputs(moduli, sel, (2, n), seed=n + mont)
    q = np.array(moduli, np.uint64)[None, :, None, None]
    for forward in (True, False):
        m1, m2 = (runner.n1, runner.n2) if forward else (runner.n2, runner.n1)
        xb = _t(x).reshape(2, len(sel), m1, m2)
        y = stage1_plain(xb, tabs, forward, mont)
        assert y.shape == (2, len(sel), m2, m1)
        digit1 = torch.stack([_digit_stage1(xb[:, k], runner.tabs[i], forward, mont)
                              for k, i in enumerate(sel)], dim=1).transpose(-1, -2)
        assert (_u(y) < 2 * q).all()
        np.testing.assert_array_equal(_u(y) % q, _u(digit1.contiguous()) % q)
        got = stage2_plain(y, tabs, forward).reshape(2, len(sel), n)
        assert torch.equal(stage2_plain(digit1, tabs, forward).reshape(got.shape), got)
        fn = mxu_ntt.mxu_ntt_limb if forward else mxu_ntt.mxu_intt_limb
        digit = torch.stack([fn(_t(x[:, k]), runner.tabs[i], mont) for k, i in enumerate(sel)],
                            dim=1)
        assert torch.equal(got, digit)
        jax_fn = pm.ntt if forward else pm.intt
        np.testing.assert_array_equal(_u(got), np.asarray(jax_fn(jnp.asarray(x),
                                                                 interpret=True)))
        assert torch.equal(runner.fused(_t(x), forward, sel, mont), got)


# ---------------------------------------------------------------------------
# The CUDA kernels' schedule (csrc/mxu_ntt.cu), modelled on the CPU
# ---------------------------------------------------------------------------

def _neg_inv64(q):
    """-q^{-1} mod 2^64 by the kernels' Newton iteration (ppq::neg_inv64)."""
    x, mask = q, (1 << 64) - 1
    for _ in range(5):
        x = x * (2 - q * x) & mask
    return -x & mask


def _model_tile(x, buf, info, fwd, first, mont, c0):
    """One block of kernel 1 (1b with ``mont``): the TC columns [c0, c0 +
    TC) of one limb's x (B, m, c), TC = min(c, 16), tables read from the
    uploaded buffer at the info row's offsets. Stage 1 returns the block's
    part of y (B, TC, m): the kernel writes each thread's values into the
    shared tile transposed, column cc's row a at [cc][a], and stores the TC
    rows of y as one run; stage 2 returns (B, m, TC)."""
    B, m, c = x.shape
    logm, (T, R, hi, lo), tc = m.bit_length() - 1, _labels(m), min(c, 16)
    q = int(info[0])
    vw, vs = buf[info[1]:info[1] + m], buf[info[1] + m:info[1] + 2 * m]
    rw, rs = buf[info[2]:info[2] + m // 2], buf[info[2] + m // 2:info[2] + m]
    tile = x[..., c0:c0 + tc].clone()
    if fwd:
        v = shoup_mul_lazy(tile[:, hi], vw[hi][..., None], vs[hi][..., None], q)
        _high(v, T, rw, rs, q, True)
        tile[:, hi] = v
        v = tile[:, lo]
        _low(v, logm, rw, rs, q, True)
        labels = lo
    else:
        v = tile[:, lo]
        if first:
            v = torch.where(v >= 2 * q, v - 2 * q, v)
        _low(v, logm, rw, rs, q, False)
        tile[:, lo] = v
        v = tile[:, hi]
        _high(v, T, rw, rs, q, False)
        labels = hi
    if not first:
        out = torch.empty_like(tile)
        if fwd:
            out[:, labels] = torch.where(v >= q, v - q, v)
        else:
            out[:, labels] = shoup_mul(v, vw[hi][..., None], vs[hi][..., None], q)
        return out
    if not fwd:
        v = shoup_mul_lazy(v, vw[hi][..., None], vs[hi][..., None], q)
    if mont:
        tw = buf[info[3]:info[3] + m * c].view(m, c)[:, c0:c0 + tc]
        v = mont_mul_lazy(v, tw[labels], q, int(u64_to_i64(_neg_inv64(q))))
    else:
        tw = buf[info[3]:info[3] + 2 * m * c].view(2, m, c)[..., c0:c0 + tc]
        v = shoup_mul_lazy(v, tw[0][labels], tw[1][labels], q)
    tile_t = torch.empty((B, tc, m), dtype=v.dtype)
    tile_t[:, :, labels] = v.permute(0, 3, 1, 2)       # (B, col, t, k) → [col][row]
    return tile_t


def _model_stage(x, buf, info, fwd, first, mont):
    """The kernel's grid over one limb: every TC-column block of x (B, m, c)."""
    blocks = [_model_tile(x, buf, info, fwd, first, mont, c0)
              for c0 in range(0, x.shape[-1], min(x.shape[-1], 16))]
    return torch.cat(blocks, dim=1 if first else 2)


@pytest.mark.parametrize("n", [1 << 11, 1 << 15, 1 << 6, 1 << 7, 1 << 9],
                         ids=["m32_64", "m128_256", "m8", "m8_16", "m16_32"])
@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("mont", [False, True], ids=["shoup", "mont"])
def test_kernel_schedule_model_matches_plain(n, forward, mont):
    """The kernels' register-blocked schedule — four stages on the top four
    bits of the row (labels t + T·k), one exchange, the rest on 16
    consecutive rows (16·t + k), twiddles root^((a mod d) << s) from Pease
    row 0, stage 1's twiddle tile (the Shoup pair, or 1b's Montgomery table
    with -q^{-1} from Newton's iteration) and transposed store — run on the
    CPU over the uploaded table buffer, block by block, equals the plain
    stages bit for bit at m ∈ {32, 64} (N=2^11) and {128, 256} (N=2^15), in
    both stages and both directions; and at m = 8 and 16 (N = 2^6, 2^7,
    2^9), where one thread holds a whole column and an 8-column stage is
    one 8-wide tile."""
    moduli, runner = _runner(n)
    sel = [2, 0]
    chain = runner.tables.streamed
    buf, info1, info2 = chain.device("cpu", sel, forward, mont)
    m1, m2 = (runner.n1, runner.n2) if forward else (runner.n2, runner.n1)
    tabs = [chain.limb(i) for i in sel]
    x = _t(_lazy_inputs(moduli, sel, (1, m1, m2), seed=n + 2 * forward + mont))
    want1 = stage1_plain(x, tabs, forward, mont)
    got1 = torch.stack([_model_stage(x[:, l], buf, info1[l], forward, True, mont)
                        for l in range(len(sel))], dim=1)
    assert torch.equal(got1, want1)
    want2 = stage2_plain(want1, tabs, forward)
    got2 = torch.stack([_model_stage(want1[:, l], buf, info2[l], forward, False, mont)
                        for l in range(len(sel))], dim=1)
    assert torch.equal(got2, want2)
    assert all(_neg_inv64(t.q) == t.qinv64 for t in tabs)


def test_ntt_stage_rejects_cpu_tensors_and_unsupported_m():
    """Kernels 1 and 1b take m ∈ {8, 16, …, 256} and whole 16-column tiles
    (8 columns at m ≤ 16), on CUDA tensors only: each refusal raises before
    any build or launch (an unsupported m before the device is looked at, so
    a CUDA tensor of that shape raises too and is never sent to a plain
    version), and the counters stay."""
    before = (cuda_mxu_ntt.launches, cuda_mxu_ntt.launches_mont)
    tabs, info = torch.zeros(8, dtype=torch.int64), torch.zeros((1, 4), dtype=torch.int64)
    for m, c, match in ((4, 32, "m in"), (512, 32, "m in"), (96, 32, "m in"),
                        (32, 40, "tiles"), (64, 32, "CUDA")):
        x = torch.zeros((1, 1, m, c), dtype=torch.int64)
        for forward in (True, False):
            for first in (True, False):
                for mont in (False, True):
                    y = torch.zeros((1, 1, c, m) if first else (1, 1, m, c), dtype=torch.int64)
                    with pytest.raises(ValueError, match=match):
                        cuda_mxu_ntt.ntt_stage(x, y, tabs, info, forward, first, mont)
    assert (cuda_mxu_ntt.launches, cuda_mxu_ntt.launches_mont) == before
    assert cuda_lib._lib is None
