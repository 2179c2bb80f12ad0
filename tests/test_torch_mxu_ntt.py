"""The port's digit-matmul NTT (plain torch version and its runner's CPU path)
against the JAX package's four-step NTTs: ``FourStepNtt.ntt/intt(...,
"mxu")`` and the fused Pallas kernel in interpret mode. Bit-exact, on a
60/40/40/20-bit chain, with lazy inputs (x + q) and limb subsets."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppqsflhe_tpu.ops.mxu_ntt import MxuNttTables as JaxTables
from ppqsflhe_tpu.ops.pallas_mxu_ntt import PallasMxuNtt
from ppqsflhe_tpu.ops.pallas_ntt import FourStepNtt
from ppqsflhe_tpu_torch.core import primes
from ppqsflhe_tpu_torch.core.ntt import NttBasis, bit_reverse_indices
from ppqsflhe_tpu_torch.ops.cuda_mxu_ntt import CudaMxuNtt
from ppqsflhe_tpu_torch.ops.mxu_ntt import MxuNttTables, mxu_intt_limb, mxu_ntt_limb


def _chain(n):
    return ([primes.first_prime_down(60, 2 * n)] + primes.prime_chain(40, 2, 2 * n)
            + [primes.next_prime_up(1 << 19, 2 * n)])


def _t(a):
    return torch.from_numpy(np.array(a, np.uint64, order="C").view(np.int64))


def _u(t):
    return t.numpy().view(np.uint64)


def _inputs(moduli, n, batch, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, size=(batch, n), dtype=np.uint64) for q in moduli],
                    axis=1)


def test_basis_and_bit_reversal_match_reference():
    from ppqsflhe_tpu.core.ntt import NttBasis as JaxBasis
    from ppqsflhe_tpu.core.ntt import bit_reverse_indices as jax_brev

    n = 1024
    moduli = _chain(n)
    assert NttBasis(n, moduli).psis == JaxBasis(n, moduli).psis
    for m in (2, 32, 128, 1024):
        np.testing.assert_array_equal(bit_reverse_indices(m), jax_brev(m))


@pytest.mark.parametrize("n", [256, 2048])
def test_tables_match_reference(n):
    """Matrices, twiddles and the REDC plan equal the JAX package's."""
    moduli = _chain(n)
    for q in moduli:
        psi = primes.root_of_unity(2 * n, q)
        t, j = MxuNttTables.build(n, q, psi), JaxTables.build(n, q, psi)
        assert (t.n1, t.n2, t.nd) == (j.n1, j.n2, j.nd)
        for name in ("a1", "a2", "a2i", "a1i"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
        for mine, quad in ((t.t1, j.t1), (t.t1i, j.t1i)):
            for val, lo, hi in ((mine[0], quad[0], quad[1]), (mine[1], quad[2], quad[3])):
                np.testing.assert_array_equal(
                    val, lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32)))
        assert (j.plan.mode, t.plan.split, t.plan.qinv_r) == ("redc", j.plan.split, j.plan.qinv_r)


@pytest.mark.parametrize("n", [256, 2048])
def test_plain_ntt_matches_fourstep_mxu(n):
    moduli = _chain(n)
    psis = [primes.root_of_unity(2 * n, q) for q in moduli]
    fs = FourStepNtt(n, moduli, psis)
    x = _inputs(moduli, n, 3, seed=n)
    ref = np.asarray(fs.ntt(jnp.asarray(x), implementation="mxu"))
    tabs = [MxuNttTables.build(n, q, p) for q, p in zip(moduli, psis)]
    got = np.stack([_u(mxu_ntt_limb(_t(x[:, i]), tabs[i])) for i in range(len(moduli))], 1)
    np.testing.assert_array_equal(got, ref)
    # lazy inputs (residue + q, the Harvey invariant) give the same output
    lazy = x + np.array(moduli, np.uint64)[None, :, None]
    got_lazy = np.stack([_u(mxu_ntt_limb(_t(lazy[:, i]), tabs[i]))
                         for i in range(len(moduli))], 1)
    np.testing.assert_array_equal(got_lazy, ref)
    # inverse
    ref_i = np.asarray(fs.intt(jnp.asarray(ref), implementation="mxu"))
    np.testing.assert_array_equal(ref_i, x)
    got_i = np.stack([_u(mxu_intt_limb(_t(ref[:, i]), tabs[i])) for i in range(len(moduli))], 1)
    np.testing.assert_array_equal(got_i, ref_i)


@pytest.mark.parametrize("idx", [None, (0, 1), (2, 3), (1,), (3, 0, 2)])
def test_runner_limb_subsets_match_fourstep(idx):
    """CudaMxuNtt's CPU path over limb subsets (any order) against
    FourStepNtt with the same ``idx``, with extra leading batch dims."""
    n = 1024
    moduli = _chain(n)
    psis = [primes.root_of_unity(2 * n, q) for q in moduli]
    fs = FourStepNtt(n, moduli, psis)
    runner = CudaMxuNtt(n, moduli, psis)
    sel = list(range(len(moduli))) if idx is None else list(idx)
    x = _inputs([moduli[i] for i in sel], n, 4, seed=7).reshape(2, 2, len(sel), n)
    ref = np.asarray(fs.ntt(jnp.asarray(x), implementation="mxu", idx=idx))
    np.testing.assert_array_equal(_u(runner.ntt(_t(x), idx)), ref)
    ref_i = np.asarray(fs.intt(jnp.asarray(ref), implementation="mxu", idx=idx))
    np.testing.assert_array_equal(_u(runner.intt(_t(ref), idx)), ref_i)


def test_runner_matches_pallas_kernel_interpret():
    """Against the fused Pallas MXU kernel itself (interpret mode), forward,
    inverse and a limb subset."""
    n = 256
    moduli = _chain(n)
    psis = [primes.root_of_unity(2 * n, q) for q in moduli]
    pm = PallasMxuNtt(n, moduli, psis)
    runner = CudaMxuNtt(n, moduli, psis)
    x = _inputs(moduli, n, 2, seed=11)
    ref = np.asarray(pm.ntt(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(_u(runner.ntt(_t(x))), ref)
    np.testing.assert_array_equal(
        _u(runner.intt(_t(ref))), np.asarray(pm.intt(jnp.asarray(ref), interpret=True)))
    sub = np.asarray(pm.ntt(jnp.asarray(x[:, 1:3]), idx=(1, 2), interpret=True))
    np.testing.assert_array_equal(_u(runner.ntt(_t(x[:, 1:3]), (1, 2))), sub)


def test_runner_rejects_wrong_limb_count():
    n = 256
    moduli = _chain(n)
    runner = CudaMxuNtt(n, moduli, [primes.root_of_unity(2 * n, q) for q in moduli])
    with pytest.raises(ValueError, match="limbs"):
        runner.ntt(torch.zeros((2, n), dtype=torch.int64), (0, 1, 2))
