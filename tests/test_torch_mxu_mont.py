"""The port's Montgomery-twiddle digit-matmul NTT (kernel 1b's plain
version) against the JAX package: the lazy Montgomery product equals
``u32pair.mont_mul64_lazy`` bit for bit, the w·2^64 mod q tables equal
``PallasMxuNtt._mont_twiddle``, and the runner with every group forced onto
the Montgomery route equals ``PallasMxuNtt`` forced the same way, in
interpret mode. Exact residues, tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppqsflhe_tpu.ops import pallas_mxu_ntt as PMX
from ppqsflhe_tpu.ops import u32pair as up
from ppqsflhe_tpu.ops.pallas_ntt import FourStepNtt
from ppqsflhe_tpu_torch.core import primes
from ppqsflhe_tpu_torch.core.modarith import mont_mul_lazy, u64_to_i64
from ppqsflhe_tpu_torch.ops import cuda_lib, cuda_mxu_ntt
from ppqsflhe_tpu_torch.ops.cuda_mxu_ntt import CudaMxuNtt
from ppqsflhe_tpu_torch.ops.mxu_ntt import mxu_intt_limb, mxu_ntt_limb


def _chain(n):
    return [primes.first_prime_down(60, 2 * n)] + primes.prime_chain(40, 2, 2 * n)


def _t(a):
    return torch.from_numpy(np.array(a, np.uint64, order="C").view(np.int64))


def _u(t):
    return t.numpy().view(np.uint64)


def _split(x):
    return (jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((x >> np.uint64(32)).astype(np.uint32)))


def _join(lo, hi):
    return np.asarray(lo).astype(np.uint64) | (np.asarray(hi).astype(np.uint64) << np.uint64(32))


@pytest.mark.parametrize("bits", [60, 59, 40, 20])
def test_mont_mul_lazy_matches_u32pair(bits):
    """a < 4q, b < q: the int64 product equals the u32-pair one, lazy
    representative included, and is a·b·2^-64 mod q below 1.25q."""
    q = primes.first_prime_down(bits, 1 << 12)
    rng = np.random.default_rng(bits)
    a = np.concatenate([rng.integers(0, 4 * q, 4000, dtype=np.uint64),
                        np.array([0, 1, q - 1, q, 4 * q - 1], np.uint64)])
    b = np.concatenate([rng.integers(0, q, 4000, dtype=np.uint64),
                        np.array([q - 1, 0, 1, q - 1, q - 1], np.uint64)])
    qinv = primes.mont_qinv_neg(q)
    qs = (np.uint32(q & 0xFFFFFFFF), np.uint32(q >> 32))
    qi = (np.uint32(qinv & 0xFFFFFFFF), np.uint32(qinv >> 32))
    want = _join(*up.mont_mul64_lazy(*_split(a), *_split(b), *qs, *qi))
    got = _u(mont_mul_lazy(_t(a), _t(b), q, int(u64_to_i64(qinv))))
    np.testing.assert_array_equal(got, want)
    assert (got < q + q // 4 + 1).all()
    rinv = pow(1 << 64, -1, q)
    assert all(int(g) % q == int(x) * int(y) * rinv % q for g, x, y in zip(got[:50], a, b))


@pytest.mark.parametrize("n", [256, 512])
def test_mont_tables_match_pallas(n):
    """t1m / t1im are PallasMxuNtt's w·2^64 mod q tables, and qinv64 its
    -q^{-1} mod 2^64."""
    moduli = _chain(n)
    psis = [primes.root_of_unity(2 * n, q) for q in moduli]
    pm = PMX.PallasMxuNtt(n, moduli, psis)
    port = CudaMxuNtt(n, moduli, psis)
    for fwd in (True, False):
        lo, hi = pm._mont_twiddle(list(range(len(moduli))), fwd)
        want = _join(lo, hi)
        for i, t in enumerate(port.tabs):
            np.testing.assert_array_equal(t.t1m if fwd else t.t1im, want[i])
    for i, t in enumerate(port.tabs):
        assert t.qinv64 == int(_join(pm._qinv64[0][i], pm._qinv64[1][i]).reshape(()))


@pytest.mark.parametrize("idx", [None, (2, 1), (0,)], ids=["all", "sub21", "sub0"])
@pytest.mark.parametrize("n", [256, 512], ids=["n256", "n512"])
def test_forced_mont_route_matches_pallas_interpret(monkeypatch, n, idx):
    """Every group on the Montgomery twiddle, both packages: the port's
    runner (plain mont path, leading batch dims) equals PallasMxuNtt in
    interpret mode, forward and inverse, and the Shoup route."""
    moduli = _chain(n)
    psis = [primes.root_of_unity(2 * n, q) for q in moduli]
    pm = PMX.PallasMxuNtt(n, moduli, psis)
    monkeypatch.setattr(PMX.PallasMxuNtt, "_group_fits",
                        lambda self, nd, twiddle_planes=4: twiddle_planes == 2)
    monkeypatch.setattr(cuda_mxu_ntt, "route", lambda n, nd: "fused_mont")
    runner = CudaMxuNtt(n, moduli, psis)
    sel = list(range(len(moduli))) if idx is None else list(idx)
    rng = np.random.default_rng(n + len(sel))
    x = np.stack([rng.integers(0, moduli[i], size=(2, 2, n), dtype=np.uint64) for i in sel],
                 axis=2)
    want = np.asarray(pm.ntt(jnp.asarray(x), idx=idx, interpret=True))
    before = (cuda_mxu_ntt.launches, cuda_mxu_ntt.launches_mont)
    got = runner.ntt(_t(x), idx)
    np.testing.assert_array_equal(_u(got), want)
    back = np.asarray(pm.intt(jnp.asarray(want), idx=idx, interpret=True))
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(_u(runner.intt(got, idx)), x)
    np.testing.assert_array_equal(
        _u(runner.fused(_t(x).reshape(4, len(sel), n), True, sel)), want.reshape(4, -1, n))
    assert (cuda_mxu_ntt.launches, cuda_mxu_ntt.launches_mont) == before
    assert cuda_lib._lib is None


def test_mont_twiddle_limb_matches_fourstep_on_lazy_inputs():
    """mxu_ntt_limb(mont=True) on inputs < 4q equals the JAX four-step XLA
    transform of the reduced inputs, and mxu_intt_limb(mont=True) inverts it."""
    n = 256
    moduli = _chain(n) + [primes.next_prime_up(1 << 19, 2 * n)]
    psis = [primes.root_of_unity(2 * n, q) for q in moduli]
    fs = FourStepNtt(n, moduli, psis)
    runner = CudaMxuNtt(n, moduli, psis)
    rng = np.random.default_rng(3)
    x = np.stack([rng.integers(0, q, size=(3, n), dtype=np.uint64) for q in moduli], axis=1)
    want = np.asarray(fs.ntt(jnp.asarray(x), implementation="mxu"))
    lazy = x + np.array([3 * q for q in moduli], np.uint64)[:, None]
    for k, t in enumerate(runner.tabs):
        got = mxu_ntt_limb(_t(lazy[:, k]), t, mont=True)
        np.testing.assert_array_equal(_u(got), want[:, k])
        np.testing.assert_array_equal(_u(mxu_intt_limb(got, t, mont=True)), x[:, k])
