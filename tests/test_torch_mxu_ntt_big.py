"""The port's streamed NTT pair (the digit-matmul plain ``stage_a``/
``stage_b``, the runner ``CudaMxuNttBig``) and its routing against the JAX
package: bit-equal to ``PallasMxuNttBig._stage_a``/``_stage_b`` run in
interpret mode, to ``FourStepNtt`` (``"mxu"``) through the "big" route, and
``route`` equal to the JAX runner's ``_group_fits`` decision. Exact integer residues, tolerance
0, on a 60/40/40/20-bit chain (nd = 9, 6, 6, 4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppqsflhe_tpu.ops.fourstep import kernel_to_std as jax_kernel_to_std
from ppqsflhe_tpu.ops.pallas_mxu_ntt import PallasMxuNtt, PallasMxuNttBig
from ppqsflhe_tpu.ops.pallas_ntt import FourStepNtt
from ppqsflhe_tpu_torch.core import primes
from ppqsflhe_tpu_torch.ops import cuda_lib, cuda_mxu_ntt, streamed_ntt
from ppqsflhe_tpu_torch.ops.cuda_mxu_ntt import CudaMxuNtt, MxuChainTables
from ppqsflhe_tpu_torch.ops.fourstep import kernel_to_std
from ppqsflhe_tpu_torch.ops.mxu_ntt import stage_a, stage_b


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


def _plain_mats(tables, sel, name):
    """The digit stage matrices of limbs ``sel`` stacked, int8 (L, nd·m, nd·m)."""
    return torch.as_tensor(np.stack([tables.tabs[i].stage_matrix(name) for i in sel]))


def _twiddles(tables, sel, forward):
    """The twiddle (w, w_shoup) of limbs ``sel``, uint64 (L, m, cols)."""
    pairs = [tables.tabs[i].t1 if forward else tables.tabs[i].t1i for i in sel]
    return tuple(np.stack([p[j] for p in pairs]) for j in (0, 1))


@pytest.fixture(scope="module")
def big512():
    n = 512                                        # n1 = 16, n2 = 32
    moduli = _chain(n)
    psis = [primes.root_of_unity(2 * n, q) for q in moduli]
    return n, moduli, PallasMxuNttBig(n, moduli, psis, blk=16), MxuChainTables(n, moduli, psis)


@pytest.mark.parametrize("idxs", [[0], [1, 2]], ids=["nd9", "nd6"])
@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("block", [None, 0, 1], ids=["all", "block0", "block1"])
def test_plain_stages_match_pallas_big_interpret(big512, idxs, forward, block):
    """stage_a then stage_b on a (B, L, m, cols) group against the Pallas
    pair in interpret mode (blk=16: several grid blocks per stage). The
    column-block cases give stage A a block of columns with the twiddle
    sliced to it (one half of the columns), as the sharded transform does."""
    n, moduli, pm, tables = big512
    sel = np.asarray(idxs)
    nd = tables.tabs[idxs[0]].nd
    shape_in = (pm.n1, pm.n2) if forward else (pm.n2, pm.n1)
    m_a = ("a1", "a2") if forward else ("a2i", "a1i")
    rng = np.random.default_rng(len(idxs) + 2 * forward)
    # lazy inputs < 4q (the contract of a transform's first stage)
    x = np.stack([rng.integers(0, 4 * moduli[i], size=(3,) + shape_in, dtype=np.uint64)
                  for i in idxs], axis=1)
    tquad = [a[sel] for a in (pm._t1 if forward else pm._t1i)]
    tw = _twiddles(tables, idxs, forward)
    if block is not None:
        c0, c1 = block * shape_in[1] // 2, (block + 1) * shape_in[1] // 2
        x = np.ascontiguousarray(x[..., c0:c1])
        tquad = [np.ascontiguousarray(a[..., c0:c1]) for a in tquad]
        tw = tuple(a[..., c0:c1] for a in tw)
    consts_a = (jnp.asarray(pm._q[0][sel]), jnp.asarray(pm._q[1][sel]),
                jnp.asarray(pm._qinv[sel]))
    lo, hi = pm._stage_a(*_split(x), pm._group_mats(m_a[0], idxs),
                         [jnp.asarray(a) for a in tquad], consts_a, shape_in[0], nd, True)
    want_a = _join(lo, hi)
    tabs = [tables.tabs[i] for i in idxs]
    got_a = stage_a(_t(x), _plain_mats(tables, idxs, m_a[0]), tw, tabs)
    np.testing.assert_array_equal(_u(got_a), want_a)
    assert (want_a < 2 * np.array(moduli, np.uint64)[sel][None, :, None, None]).all()
    if block is not None:
        return
    consts_b = (jnp.asarray(pm._q[0][sel]), jnp.asarray(pm._q[1][sel]),
                jnp.asarray(pm._q2[0][sel]), jnp.asarray(pm._q2[1][sel]),
                jnp.asarray(pm._qinv[sel]))
    olo, ohi = pm._stage_b(lo, hi, pm._group_mats(m_a[1], idxs), consts_b, shape_in[1], nd,
                           True)
    got_b = stage_b(_t(want_a), _plain_mats(tables, idxs, m_a[1]), tabs)
    assert got_b.shape == (3, len(idxs), shape_in[1], shape_in[0])
    np.testing.assert_array_equal(_u(got_b), _join(olo, ohi))


@pytest.mark.parametrize("idx", [None, (0,), (3, 0, 2), (1, 2)])
@pytest.mark.parametrize("routing", ["big", "mixed"])
def test_runner_big_route_matches_fourstep(monkeypatch, idx, routing):
    """CudaMxuNtt's CPU path with every group (or the nd=9 group alone)
    routed "big" — the plain streamed pair — is bit-equal to
    FourStepNtt's "mxu" transform, forward and inverse, with leading batch
    dims and limb subsets in any order."""
    monkeypatch.setattr(cuda_mxu_ntt, "route",
                        lambda n, nd: "big" if routing == "big" or nd == 9 else "fused")
    n = 1024
    moduli = _chain(n)
    psis = [primes.root_of_unity(2 * n, q) for q in moduli]
    fs = FourStepNtt(n, moduli, psis)
    runner = CudaMxuNtt(n, moduli, psis)
    sel = list(range(len(moduli))) if idx is None else list(idx)
    rng = np.random.default_rng(len(sel))
    x = np.stack([rng.integers(0, moduli[i], size=(2, 2, n), dtype=np.uint64) for i in sel],
                 axis=2)
    ref = np.asarray(fs.ntt(jnp.asarray(x), implementation="mxu", idx=idx))
    np.testing.assert_array_equal(_u(runner.ntt(_t(x), idx)), ref)
    np.testing.assert_array_equal(_u(runner.big.ntt(_t(x), idx)), ref)
    back = np.asarray(fs.intt(jnp.asarray(ref), implementation="mxu", idx=idx))
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(_u(runner.intt(_t(ref), idx)), back)


@pytest.mark.parametrize("log_n", [12, 13, 14, 15, 16])
@pytest.mark.parametrize("nd", [3, 6, 9])
def test_route_matches_jax_group_fits(log_n, nd):
    """route(n, nd) is the JAX runner's choice at its default budget
    (``PallasMxuNtt._run``): the fused Shoup kernel when its cell fits, the
    fused Montgomery-twiddle kernel when only the 2-plane cell fits, else
    the streamed pair. No N=2^16 tables are built."""
    n = 1 << log_n
    pm = PallasMxuNtt.__new__(PallasMxuNtt)
    pm.n, pm.n1 = n, 1 << ((n.bit_length() - 1) // 2)
    pm.n2 = n // pm.n1
    pm._vmem_budget = 1024 * 12896                # PPQSFLHE_FUSED_VMEM_KIB unset
    assert cuda_mxu_ntt.FUSED_VMEM_BUDGET == pm._vmem_budget
    fits_shoup = pm._group_fits(nd, 4)
    fits_mont = fits_shoup or pm._group_fits(nd, 2)
    want = "fused" if fits_shoup else "fused_mont" if fits_mont else "big"
    assert cuda_mxu_ntt.route(n, nd) == want
    # the anchors of the JAX docstrings: nd=9 at N >= 2^15 streams, nd=6 at
    # N=2^16 takes the Montgomery twiddle
    assert cuda_mxu_ntt.route(n, nd) == ("big" if nd == 9 and log_n >= 15 else
                                         "fused_mont" if nd == 6 and log_n == 16 else "fused")


@pytest.mark.parametrize("n", [16, 256, 512, 1 << 15])
def test_kernel_to_std_matches_reference(n):
    np.testing.assert_array_equal(kernel_to_std(n), jax_kernel_to_std(n))


def test_big_route_stays_on_cpu_and_launchers_reject_cpu_tensors(monkeypatch):
    """The big route's CPU path launches nothing and builds nothing; the
    kernel 4/5 launchers refuse CPU tensors and a column block outside its
    twiddle table before any build."""
    monkeypatch.setattr(cuda_mxu_ntt, "route", lambda n, nd: "big")
    n = 256
    moduli = _chain(n)
    runner = CudaMxuNtt(n, moduli, [primes.root_of_unity(2 * n, q) for q in moduli])
    before = (cuda_mxu_ntt.launches, streamed_ntt.launches_stage_a,
              streamed_ntt.launches_stage_b)
    x = _t(np.stack([np.arange(n, dtype=np.uint64) % q for q in moduli]))
    assert torch.equal(runner.intt(runner.ntt(x)), x)
    x = torch.zeros((1, 1, 128, 32), dtype=torch.int64)
    tabs, info = torch.zeros(8, dtype=torch.int64), torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        streamed_ntt.stage_a(x, x, tabs, info, True, tw_cols=32)
    with pytest.raises(ValueError, match="outside"):
        streamed_ntt.stage_a(x, x, tabs, info, True, tw_cols=48, col0=32)
    with pytest.raises(ValueError, match="CUDA"):
        streamed_ntt.stage_b(x.reshape(1, 1, 32, 128), x, tabs, info, True)
    assert (cuda_mxu_ntt.launches, streamed_ntt.launches_stage_a,
            streamed_ntt.launches_stage_b) == before
    assert cuda_lib._lib is None
