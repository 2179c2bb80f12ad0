"""The streamed NTT pair as Shoup butterflies (``ops/streamed_ntt.py``,
kernels 4 and 5) against the JAX package's ``PallasMxuNttBig`` run in
interpret mode, against the port's kernel-6 plain transform, and the CUDA
kernels' thread schedule, modelled step for step, against the plain stages.
Exact integer residues, tolerance 0 (stage A: ≡ mod q, < 2q), on the nd=9 and
nd=6 limbs of a 60/40/40/20-bit chain."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppqsflhe_tpu.ops.pallas_mxu_ntt import PallasMxuNttBig
from ppqsflhe_tpu_torch.core import primes
from ppqsflhe_tpu_torch.core.modarith import shoup_mul, shoup_mul_lazy
from ppqsflhe_tpu_torch.ops import cuda_lib, streamed_ntt
from ppqsflhe_tpu_torch.ops.cuda_mxu_ntt import CudaMxuNtt, CudaMxuNttBig, MxuChainTables
from ppqsflhe_tpu_torch.ops.cuda_ntt import CudaFourStepNtt
from ppqsflhe_tpu_torch.ops.streamed_ntt import StreamedChain, stage_a_plain, stage_b_plain


def _chain(n):
    return ([primes.first_prime_down(60, 2 * n)] + primes.prime_chain(40, 2, 2 * n)
            + [primes.next_prime_up(1 << 19, 2 * n)])


def _t(a):
    return torch.from_numpy(np.array(a, np.uint64, order="C").view(np.int64))


def _u(t):
    return t.numpy().view(np.uint64)


def _join(lo, hi):
    return np.asarray(lo).astype(np.uint64) | (np.asarray(hi).astype(np.uint64) << np.uint64(32))


def _split(x):
    return (jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((x >> np.uint64(32)).astype(np.uint32)))


_WORLDS = {}


def _world(n):
    """(moduli, psis, JAX streamed pair with several grid blocks per stage,
    the port's chain tables and its streamed tables), built once per n."""
    if n not in _WORLDS:
        moduli = _chain(n)
        psis = [primes.root_of_unity(2 * n, q) for q in moduli]
        tables = MxuChainTables(n, moduli, psis)
        _WORLDS[n] = (moduli, psis, PallasMxuNttBig(n, moduli, psis, blk=16), tables,
                      StreamedChain(tables.tabs))
    return _WORLDS[n]


def _jax_stage_a(pm, x, idxs, forward):
    sel = np.asarray(idxs)
    nd = pm.tabs[idxs[0]].nd
    m_a = ("a1", "a2") if forward else ("a2i", "a1i")
    tquad = [a[sel] for a in (pm._t1 if forward else pm._t1i)]
    consts = (jnp.asarray(pm._q[0][sel]), jnp.asarray(pm._q[1][sel]), jnp.asarray(pm._qinv[sel]))
    return pm._stage_a(*_split(x), pm._group_mats(m_a[0], idxs), [jnp.asarray(a) for a in tquad],
                       consts, x.shape[2], nd, True)


def _jax_stage_b(pm, lo, hi, idxs, forward):
    sel = np.asarray(idxs)
    nd = pm.tabs[idxs[0]].nd
    consts = (jnp.asarray(pm._q[0][sel]), jnp.asarray(pm._q[1][sel]),
              jnp.asarray(pm._q2[0][sel]), jnp.asarray(pm._q2[1][sel]),
              jnp.asarray(pm._qinv[sel]))
    mat = pm._group_mats("a2" if forward else "a1i", idxs)
    return _join(*pm._stage_b(lo, hi, mat, consts, lo.shape[3], nd, True))


def _inputs(moduli, idxs, shape, seed):
    """Lazy residues < 4q per limb (the contract of a transform's first
    stage), stacked on axis 1 of (3, L) + shape."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, 4 * moduli[i], size=(3,) + shape, dtype=np.uint64)
                     for i in idxs], axis=1)


@pytest.mark.parametrize("n", [512, 2048])
@pytest.mark.parametrize("idxs", [[0], [1, 2]], ids=["nd9", "nd6"])
@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
def test_plain_stage_b_matches_pallas_big_interpret(n, idxs, forward):
    """The new plain stage B, fed the JAX stage A's output (< 2q), is
    bit-equal to ``PallasMxuNttBig._stage_b`` in interpret mode."""
    moduli, _, pm, _, chain = _world(n)
    shape_in = (pm.n1, pm.n2) if forward else (pm.n2, pm.n1)
    x = _inputs(moduli, idxs, shape_in, seed=n + len(idxs) + 2 * forward)
    lo, hi = _jax_stage_a(pm, x, idxs, forward)
    want = _jax_stage_b(pm, lo, hi, idxs, forward)
    got = stage_b_plain(_t(_join(lo, hi)), [chain.limb(i) for i in idxs], forward)
    assert got.shape == (3, len(idxs), shape_in[1], shape_in[0])
    np.testing.assert_array_equal(_u(got), want)


@pytest.mark.parametrize("n", [512, 2048])
@pytest.mark.parametrize("idxs", [[0], [1, 2]], ids=["nd9", "nd6"])
@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("block", [None, 1], ids=["all", "block1"])
def test_plain_stage_a_matches_pallas_big_mod_q(n, idxs, forward, block):
    """The new plain stage A on inputs < 4q is ≡ ``PallasMxuNttBig._stage_a``
    mod q and < 2q (the lazy representative differs: a Shoup product, not a
    REDC, ends it), on all columns and on the second half of them with the
    twiddle table sliced by ``col0`` (the sharded transform's block)."""
    moduli, _, pm, _, chain = _world(n)
    shape_in = (pm.n1, pm.n2) if forward else (pm.n2, pm.n1)
    x = _inputs(moduli, idxs, shape_in, seed=7 * n + len(idxs) + 2 * forward)
    want = _join(*_jax_stage_a(pm, x, idxs, forward))
    col0 = 0
    if block is not None:
        col0 = shape_in[1] // 2
        x, want = (np.ascontiguousarray(a[..., col0:]) for a in (x, want))
    got = _u(stage_a_plain(_t(x), [chain.limb(i) for i in idxs], forward, col0))
    q = np.array(moduli, np.uint64)[idxs][None, :, None, None]
    assert (got < 2 * q).all()
    np.testing.assert_array_equal(got % q, want % q)


@pytest.mark.parametrize("n", [512, 2048])
@pytest.mark.parametrize("idx", [None, (0,), (3, 0, 2)])
def test_big_route_matches_jax_run_and_kernel6(n, idx):
    """``CudaMxuNttBig.ntt``/``intt`` on the CPU (the new plain pair) is
    bit-equal to the JAX ``PallasMxuNttBig._run`` in interpret mode and to
    the port's kernel-6 plain transform, forward and inverse, with leading
    batch dims and limb subsets in any order."""
    moduli, psis, pm, tables, _ = _world(n)
    big = CudaMxuNttBig(tables)
    bf = CudaFourStepNtt(n, moduli, psis)
    sel = list(range(len(moduli))) if idx is None else list(idx)
    rng = np.random.default_rng(len(sel) + n)
    x = np.stack([rng.integers(0, moduli[i], size=(2, 2, n), dtype=np.uint64) for i in sel],
                 axis=2)
    ref = np.asarray(pm._run(jnp.asarray(x), True, idx, True))
    got = big.ntt(_t(x), idx)
    np.testing.assert_array_equal(_u(got), ref)
    np.testing.assert_array_equal(_u(got), _u(bf.ntt(_t(x), idx)))
    back = np.asarray(pm._run(jnp.asarray(ref), False, idx, True))
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(_u(big.intt(_t(ref), idx)), back)
    np.testing.assert_array_equal(_u(bf.intt(_t(ref), idx)), back)


# ---------------------------------------------------------------------------
# The CUDA kernels' schedule (csrc/streamed_ntt.cu), modelled on the CPU
# ---------------------------------------------------------------------------

def _labels(m):
    """(T, R, hi, lo): T threads a column of R values each (R = 16, or m
    itself at m ≤ 16), their row labels t + T·k and R·t + k."""
    R = min(m, 16)
    T = m // R
    hi = torch.arange(T)[:, None] + T * torch.arange(R)[None, :]      # label t + T·k
    lo = R * torch.arange(T)[:, None] + torch.arange(R)[None, :]      # label R·t + k
    return T, R, hi, lo


def _high(v, T, rw, rs, q, fwd):
    """high_stages: v (..., T, R, cols) holds row labels t + T·k; log2(R)
    stages (all of them when one thread holds the column)."""
    t = torch.arange(T)
    R = v.shape[-2]
    S = R.bit_length() - 1
    for it in range(S):
        s = it if fwd else S - 1 - it
        dk = (R // 2) >> s
        for k in range(R):
            if k & dk:
                continue
            e = (t + T * (k & (dk - 1))) << s
            _butterfly(v, k, k + dk, rw[e][:, None], rs[e][:, None], q, fwd)


def _low(v, logm, rw, rs, q, fwd):
    """low_stages: v (..., T, 16, cols) holds row labels 16·t + k."""
    for it in range(logm - 4):
        s = 4 + it if fwd else logm - 1 - it
        d = 1 << (logm - 1 - s)
        for k in range(16):
            if k & d:
                continue
            e = (k & (d - 1)) << s
            _butterfly(v, k, k + d, rw[e], rs[e], q, fwd)


def _butterfly(v, i, j, w, ws, q, fwd):
    q2 = 2 * q
    u, x = v[..., i, :], v[..., j, :]
    if fwd:
        s = u + x
        d = shoup_mul_lazy(u + q2 - x, w, ws, q)
        v[..., i, :], v[..., j, :] = torch.where(s >= q2, s - q2, s), d
    else:
        b = shoup_mul_lazy(x, w, ws, q)
        s, d = u + b, u + q2 - b
        v[..., i, :], v[..., j, :] = (torch.where(s >= q2, s - q2, s),
                                      torch.where(d >= q2, d - q2, d))


def _model_limb(cols, buf, info, fwd, stage_a, tw_cols=0, col0=0):
    """One limb of either kernel: ``cols`` (B, m, c) holds the columns that
    the block's threads transform (stage A: x's columns; stage B: the rows of
    t, transposed), tables read from the uploaded buffer at the info row's
    offsets. Returns (B, m, c) in the store's row order."""
    B, m, c = cols.shape
    logm, (T, R, hi, lo) = m.bit_length() - 1, _labels(m)
    q = int(info[0])
    vw, vs = buf[info[1]:info[1] + m], buf[info[1] + m:info[1] + 2 * m]
    rw, rs = buf[info[2]:info[2] + m // 2], buf[info[2] + m // 2:info[2] + m]
    tile = cols.clone()
    if fwd:
        v = shoup_mul_lazy(tile[:, hi], vw[hi][..., None], vs[hi][..., None], q)
        _high(v, T, rw, rs, q, True)
        tile[:, hi] = v
        v = tile[:, lo]
        _low(v, logm, rw, rs, q, True)
        labels = lo
    else:
        v = tile[:, lo]
        if stage_a:
            v = torch.where(v >= 2 * q, v - 2 * q, v)
        _low(v, logm, rw, rs, q, False)
        tile[:, lo] = v
        v = tile[:, hi]
        _high(v, T, rw, rs, q, False)
        labels = hi
    out = torch.empty_like(cols)
    if stage_a:
        tw = buf[info[3]:info[3] + 2 * m * tw_cols].view(2, m, tw_cols)[..., col0:col0 + c]
        if not fwd:
            v = shoup_mul_lazy(v, vw[hi][..., None], vs[hi][..., None], q)
        out[:, labels] = shoup_mul_lazy(v, tw[0][labels], tw[1][labels], q)
    elif fwd:
        out[:, labels] = torch.where(v >= q, v - q, v)
    else:
        out[:, labels] = shoup_mul(v, vw[hi][..., None], vs[hi][..., None], q)
    return out


@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("sel", [[0], [2, 0]], ids=["q0", "q2q0"])
def test_kernel_schedule_model_matches_plain(forward, sel):
    """The kernels' register-blocked schedule — four stages on the top four
    bits of the row (labels t + T·k), one exchange, the rest on 16
    consecutive rows (16·t + k), root^((a mod d) << s) from Pease row 0 —
    run on the CPU over the uploaded table buffer, equals the plain stages
    bit for bit at N=2^15 (m = 128 and 256 in both stages), with stage A also
    on the second half of its columns, and after a re-upload for a grown limb
    subset."""
    n = 1 << 15
    moduli = _chain(n)[:3]
    psis = [primes.root_of_unity(2 * n, q) for q in moduli]
    tables = MxuChainTables(n, moduli, psis)
    chain = StreamedChain(tables.tabs)
    chain.device("cpu", [1], forward)          # a first upload the next call must grow
    buf, info_a, info_b = chain.device("cpu", sel, forward)
    assert chain._dev["cpu"]["limbs"] == set(sel) | {1}
    m1, m2 = (tables.n1, tables.n2) if forward else (tables.n2, tables.n1)
    tabs = [chain.limb(i) for i in sel]
    x = _t(_inputs(moduli, sel, (m1, m2), seed=forward)[:1])
    want_a = stage_a_plain(x, tabs, forward)
    got_a = torch.stack([_model_limb(x[:, l], buf, info_a[l], forward, True, m2)
                         for l in range(len(sel))], dim=1)
    assert torch.equal(got_a, want_a)
    h = m2 // 2
    got_h = torch.stack([_model_limb(x[:, l, :, h:], buf, info_a[l], forward, True, m2, h)
                         for l in range(len(sel))], dim=1)
    assert torch.equal(got_h, stage_a_plain(x[..., h:], tabs, forward, h))
    want_b = stage_b_plain(want_a, tabs, forward)
    got_b = torch.stack([_model_limb(want_a[:, l].transpose(-1, -2), buf, info_b[l], forward,
                                     False) for l in range(len(sel))], dim=1)
    assert torch.equal(got_b, want_b)


@pytest.mark.parametrize("n", [1 << 6, 1 << 7, 1 << 9], ids=["m8", "m8_16", "m16_32"])
@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
def test_kernel_schedule_model_small_m(n, forward):
    """At m = 8 and 16 one thread holds a whole column (R = m values, every
    stage in registers, no exchange): the model equals the plain stages bit
    for bit, stage A on every column block of a coef axis of 2, 4 and 8
    ranks (c down to 1, stage B over m1/D rows) too."""
    moduli = _chain(n)[:2]
    psis = [primes.root_of_unity(2 * n, q) for q in moduli]
    tables = MxuChainTables(n, moduli, psis)
    chain, sel = StreamedChain(tables.tabs), [1, 0]
    buf, info_a, info_b = chain.device("cpu", sel, forward)
    m1, m2 = (tables.n1, tables.n2) if forward else (tables.n2, tables.n1)
    assert min(m1, m2) <= 16
    tabs = [chain.limb(i) for i in sel]
    x = _t(_inputs(moduli, sel, (m1, m2), seed=n + forward)[:1])
    for D in (1, 2, 4, 8):
        c = m2 // D
        for k in range(D):
            xk = x[..., k * c:(k + 1) * c]
            want_a = stage_a_plain(xk, tabs, forward, k * c)
            got_a = torch.stack([_model_limb(xk[:, l], buf, info_a[l], forward, True, m2, k * c)
                                 for l in range(len(sel))], dim=1)
            assert torch.equal(got_a, want_a)
    want_a = stage_a_plain(x, tabs, forward)
    for D in (1, 2, 4, 8):
        rows = m1 // D
        t = want_a[..., :rows, :]              # rank 0's rows after the exchange
        got_b = torch.stack([_model_limb(t[:, l].transpose(-1, -2), buf, info_b[l], forward,
                                         False) for l in range(len(sel))], dim=1)
        assert torch.equal(got_b, stage_b_plain(t.contiguous(), tabs, forward))


def test_streamed_launchers_reject_cpu_tensors_and_bad_blocks():
    """Kernels 4 and 5 take CUDA tensors only, and blocks of whole 16-wide
    tiles or a power of two below 16 (stage A: inside its table, starting on
    a tile): each refusal raises before any build or launch, and the
    counters stay."""
    before = (streamed_ntt.launches_stage_a, streamed_ntt.launches_stage_b)
    x = torch.zeros((1, 1, 128, 32), dtype=torch.int64)
    tabs, info = torch.zeros(8, dtype=torch.int64), torch.zeros((1, 4), dtype=torch.int64)
    for fwd in (True, False):
        with pytest.raises(ValueError, match="CUDA"):
            streamed_ntt.stage_a(x, x, tabs, info, fwd, tw_cols=32)
        with pytest.raises(ValueError, match="outside"):
            streamed_ntt.stage_a(x, x, tabs, info, fwd, tw_cols=48, col0=32)
        with pytest.raises(ValueError, match="tiles"):
            streamed_ntt.stage_a(x, x, tabs, info, fwd, tw_cols=40, col0=8)
        with pytest.raises(ValueError, match="CUDA"):
            streamed_ntt.stage_b(x, x.reshape(1, 1, 32, 128), tabs, info, fwd)
        with pytest.raises(ValueError, match="tiles"):
            streamed_ntt.stage_b(x.reshape(1, 1, 32, 128)[:, :, :24].contiguous(), x, tabs,
                                 info, fwd)
    assert (streamed_ntt.launches_stage_a, streamed_ntt.launches_stage_b) == before
    assert cuda_lib._lib is None


def test_fused_tables_upload_only_the_limbs_asked_for():
    """The fused route (kernels 1 and 1b) builds and uploads no digit stage
    matrix: it takes the streamed pair's butterfly tables, uploaded only for
    the limbs asked for; a new limb grows the upload, and each limb's info
    rows point at its own vectors, Pease rows and twiddle (with ``mont``, its
    own Montgomery table)."""
    n = 512
    moduli = _chain(n)
    psis = [primes.root_of_unity(2 * n, q) for q in moduli]
    runner = CudaMxuNtt(n, moduli, psis)
    tables, chain = runner.tables, runner.tables.streamed
    x = _t(_inputs(moduli, [1, 3], (n,), seed=5))
    for fwd, mont in ((True, False), (False, True)):
        runner.fused(x, fwd, [1, 3], mont)
    assert all(not t._mats for t in tables.tabs)
    assert "cpu" not in chain._dev
    chain.device("cpu", [1], True)
    assert chain._dev["cpu"]["limbs"] == {1}
    buf, info1, info2 = chain.device("cpu", [3, 1], False, mont=True)
    assert chain._dev["cpu"]["limbs"] == {1, 3}
    assert buf.numel() == sum(a.size for i in (1, 3) for fwd in (True, False)
                              for a in chain.limb(i).blocks(fwd).values())
    for row1, row2, i in zip(info1.tolist(), info2.tolist(), (3, 1)):
        t = chain.limb(i)
        blocks = t.blocks(False)
        assert row1[0] == row2[0] == t.q and row2[3] == 0
        for row, names in ((row1, ("vec_a", "root_a", "twm")), (row2, ("vec_b", "root_b"))):
            for off, name in zip(row[1:], names):
                a = blocks[name]
                assert torch.equal(buf[off:off + a.size], torch.from_numpy(a.view(np.int64)))
        np.testing.assert_array_equal(blocks["twm"], tables.tabs[i].t1im.reshape(-1))
    assert all(not t._mats for t in tables.tabs)
