"""The port's radix-2 transforms against the JAX package's: the bit-reversed
ψ tables equal ``NttBasis``'s, ``ntt``/``intt`` equal ``_ntt_impl``/
``_intt_impl`` over limb subsets with leading batch dims, and a radix-2
context's Galois permutations equal the JAX radix-2 context's. Exact
residues, tolerance 0, at N = 128…1024 with 3–5 limbs."""

import dataclasses

import numpy as np
import pytest
import torch

from ppqsflhe_tpu.ckks.params import CkksContext as JaxContext
from ppqsflhe_tpu.ckks.params import CkksParams as JaxParams
from ppqsflhe_tpu.core.ntt import NttBasis as JaxBasis
from ppqsflhe_tpu.core.ntt import _intt_impl, _ntt_impl
from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.ckks.eval import rot_to_galois
from ppqsflhe_tpu_torch.ckks.params import CkksContext
from ppqsflhe_tpu_torch.core import primes
from ppqsflhe_tpu_torch.core.ntt import NttBasis, Radix2Ntt


def _chain(n, limbs):
    qs = [primes.first_prime_down(60, 2 * n)] + primes.prime_chain(40, 3, 2 * n)
    return (qs + [primes.next_prime_up(1 << 19, 2 * n)])[:limbs]


@pytest.mark.parametrize("n, limbs", [(128, 3), (256, 4), (512, 5), (1024, 3)])
def test_transforms_match_jax(n, limbs):
    moduli = _chain(n, limbs)
    jb = JaxBasis(n, moduli)
    port = Radix2Ntt(NttBasis(n, moduli))
    for name in ("psi_rev", "psi_rev_shoup", "ipsi_rev", "ipsi_rev_shoup", "ninv", "ninv_shoup"):
        np.testing.assert_array_equal(getattr(port, name), getattr(jb, name), err_msg=name)
    sel = [limbs - 1, 0] if limbs > 3 else list(range(limbs))
    rng = np.random.default_rng(n + limbs)
    x = np.stack([rng.integers(0, moduli[i], (2, 3, n), dtype=np.uint64) for i in sel], axis=2)
    s = np.asarray(sel)
    want = np.asarray(_ntt_impl(x, jb.psi_rev[s], jb.psi_rev_shoup[s], jb.q_vec[s], n))
    got = port.ntt(torch.from_numpy(x.view(np.int64)), sel)
    assert got.shape == (2, 3, len(sel), n)
    np.testing.assert_array_equal(convert.residues_np(got), want)
    back = np.asarray(_intt_impl(want, jb.ipsi_rev[s], jb.ipsi_rev_shoup[s], jb.ninv[s],
                                 jb.ninv_shoup[s], jb.q_vec[s], n))
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(
        convert.residues_np(port.intt(torch.from_numpy(want.view(np.int64)), sel)), x)


def test_radix2_context_and_galois_perm():
    """A radix-2 context transforms like the JAX radix-2 context, and its
    Galois permutations (plain bit-reversed bins) are the JAX context's."""
    jp = JaxParams.generate(n=256, mult_depth=2, scale_bits=40, dnum=2)
    assert jp.ntt_backend == "radix2"
    jctx = JaxContext(jp)
    ctx = CkksContext(convert.params(dataclasses.asdict(jp)))
    assert ctx.radix2 and isinstance(ctx.fntt, Radix2Ntt)
    for g in (rot_to_galois(1, 256), rot_to_galois(-3, 256), 2 * 256 - 1):
        np.testing.assert_array_equal(ctx.galois_perm(g, "cpu").numpy(), jctx.galois_perm(g))
    rng = np.random.default_rng(3)
    idx = (0, 1, 2, 3)
    x = np.stack([rng.integers(0, ctx.moduli_qp[i], 256, dtype=np.uint64) for i in idx])
    np.testing.assert_array_equal(
        convert.residues_np(ctx.ntt(torch.from_numpy(x.view(np.int64)), idx)),
        np.asarray(jctx.ntt(x, idx)))
