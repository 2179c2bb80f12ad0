"""The port's butterfly four-step NTT (kernel 6's plain version, its tables
and runner) against the JAX package: the tables equal
``FourStepTables.u64``; the plain transform equals
``FourStepNtt(implementation="pallas")`` run in interpret mode and
``implementation="xla"``. Exact residues, tolerance 0, on a 60/40/40/20-bit
chain at N = 256, 512 (n1 ≠ n2) and 1024. Also ``ntt_impl`` through
``convert`` and the entry points' default device."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ppqsflhe_tpu.ckks.params import CkksParams as JaxParams
from ppqsflhe_tpu.ops.pallas_ntt import FourStepNtt as JaxFourStepNtt
from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.ckks.params import CkksParams
from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
from ppqsflhe_tpu_torch.core import primes
from ppqsflhe_tpu_torch.ops import cuda_lib, cuda_ntt
from ppqsflhe_tpu_torch.ops.cuda_mxu_ntt import CudaMxuNtt
from ppqsflhe_tpu_torch.ops.cuda_ntt import BUTTERFLY, MXU, CudaFourStepNtt, four_step_ntt


def _chain(n):
    return ([primes.first_prime_down(60, 2 * n)] + primes.prime_chain(40, 2, 2 * n)
            + [primes.next_prime_up(1 << 19, 2 * n)])


def _t(a):
    return torch.from_numpy(np.array(a, np.uint64, order="C").view(np.int64))


def _u(t):
    return t.numpy().view(np.uint64)


@functools.lru_cache(maxsize=None)
def _ring(n):
    moduli = _chain(n)
    psis = [primes.root_of_unity(2 * n, q) for q in moduli]
    return n, moduli, JaxFourStepNtt(n, moduli, psis), CudaFourStepNtt(n, moduli, psis)


@pytest.fixture(params=[256, 512, 1024], ids=["n256", "n512", "n1024"])
def ring(request):
    return _ring(request.param)


def test_tables_match_jax_u64(ring):
    """Every ported table is the u64 twin of the JAX FourStepTables.build,
    bit for bit."""
    n, moduli, fs, port = ring
    assert (port.n1, port.n2) == (fs.n1, fs.n2)
    for mine, ref in zip(port.tabs, fs.tabs):
        for name in ("twist", "itwist", "twiddle", "itwiddle", "pgs1", "pgs2", "pct1", "pct2"):
            for a, b in zip(getattr(mine, name), ref.u64[name]):
                assert a.dtype == np.uint64
                np.testing.assert_array_equal(a, b.reshape(a.shape), err_msg=name)


@pytest.mark.parametrize("idx", [None, (2, 0), (3,)], ids=["all", "sub20", "sub3"])
def test_plain_body_matches_pallas_interpret(ring, idx):
    """Forward and inverse over a limb subset with leading batch dims: the
    plain body equals the Pallas kernel in interpret mode; inputs + q (the
    twist's lazy range) give the same evaluations; intt(ntt(x)) == x."""
    n, moduli, fs, port = ring
    sel = list(range(len(moduli))) if idx is None else list(idx)
    rng = np.random.default_rng(n + len(sel))
    x = np.stack([rng.integers(0, moduli[i], size=(2, 2, n), dtype=np.uint64) for i in sel],
                 axis=2)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fs.ntt(jnp.asarray(x), implementation="pallas", idx=idx))
        back = np.asarray(fs.intt(jnp.asarray(want), implementation="pallas", idx=idx))
    np.testing.assert_array_equal(back, x)
    got = port.ntt(_t(x), idx)
    assert got.shape == (2, 2, len(sel), n)
    np.testing.assert_array_equal(_u(got), want)
    lazy = x + np.array([moduli[i] for i in sel], np.uint64)[:, None]
    np.testing.assert_array_equal(_u(port.ntt(_t(lazy), idx)), want)
    np.testing.assert_array_equal(_u(port.intt(_t(want), idx)), x)


def test_plain_body_matches_xla():
    """The plain body equals the JAX four-step XLA transform both ways (at
    N=256: the XLA transform's compile is slow)."""
    n, moduli, fs, port = _ring(256)
    rng = np.random.default_rng(1)
    x = np.stack([rng.integers(0, q, size=(3, n), dtype=np.uint64) for q in moduli], axis=1)
    want = np.asarray(fs.ntt(jnp.asarray(x), implementation="xla"))
    np.testing.assert_array_equal(_u(port.ntt(_t(x))), want)
    np.testing.assert_array_equal(_u(port.intt(_t(want))), x)


def test_dispatch_and_launcher_stay_off_the_card():
    """four_step_ntt builds the runner ntt_impl names; both give the same
    bits. On CPU tensors nothing launches or builds; the kernel 6 launcher
    refuses CPU tensors."""
    n = 512
    moduli = _chain(n)
    psis = [primes.root_of_unity(2 * n, q) for q in moduli]
    mxu, bfly = four_step_ntt(n, moduli, psis), four_step_ntt(n, moduli, psis, BUTTERFLY)
    assert isinstance(mxu, CudaMxuNtt) and isinstance(bfly, CudaFourStepNtt)
    assert isinstance(four_step_ntt(n, moduli, psis, MXU), CudaMxuNtt)
    np.testing.assert_array_equal(mxu.perm_to_std, bfly.perm_to_std)
    with pytest.raises(ValueError, match="ntt_impl"):
        four_step_ntt(n, moduli, psis, "xla")
    before = cuda_ntt.launches
    rng = np.random.default_rng(2)
    x = _t(np.stack([rng.integers(0, q, size=(3, n), dtype=np.uint64) for q in moduli],
                    axis=1))
    y = bfly.ntt(x[:, 1:], (1, 2, 3))
    assert torch.equal(y, mxu.ntt(x[:, 1:], (1, 2, 3)))
    assert torch.equal(mxu.intt(y, (1, 2, 3)), x[:, 1:])
    z = torch.zeros((1, 1, 32, 32), dtype=torch.int64)
    info = torch.zeros((1, cuda_ntt.INFO), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ntt.fourstep_pass(z, z, z, info, forward=True, first=False)
    assert cuda_ntt.launches == before
    assert cuda_lib._lib is None


@pytest.mark.parametrize("jax_impl, port_impl", [("xla", MXU), ("mxu", MXU),
                                                 ("pallas_mxu", MXU), ("pallas", BUTTERFLY)])
def test_convert_maps_ntt_impl(jax_impl, port_impl):
    """convert.params keeps every JAX four-step ntt_impl by its name (so a CC
    document re-emits unchanged) and the context maps it to the port's
    runner; params_fields gives it back (a round trip)."""
    fields = dataclasses.asdict(JaxParams.generate(n=1 << 10, ntt_backend="fourstep",
                                                   ntt_impl=jax_impl))
    p = convert.params(fields)
    assert p.ntt_impl == jax_impl and cuda_ntt.RUNNER[p.ntt_impl] == port_impl
    runner = CudaMxuNtt if port_impl == MXU else CudaFourStepNtt
    assert isinstance(CkksScheme(p, device="cpu").ctx.fntt, runner)
    back = convert.params_fields(p)
    assert back["ntt_impl"] == jax_impl and back["ntt_backend"] == "fourstep"
    assert convert.params(back) == p
    assert CkksParams.generate(n=1 << 10, ntt_impl=jax_impl) == p
    with pytest.raises(ValueError, match="ntt_impl"):
        convert.params(dict(fields, ntt_impl="radix"))


def test_entry_points_default_to_the_card():
    """CkksScheme, the converters and galois_perm put tensors on the card
    unless the caller names another device (nothing is uploaded here: this
    machine has no card)."""
    import inspect

    sch = CkksScheme(CkksParams.generate(n=256))
    assert sch.device == torch.device("cuda")
    assert sch.params.ntt_impl == MXU
    for fn in (convert.residues, convert.secret_key, convert.public_key,
               convert.keyswitch_key, convert.rotation_keys, convert.ciphertext,
               sch.ctx.galois_perm):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
