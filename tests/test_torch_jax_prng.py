"""``core/jax_prng.py`` replays ``jax.random`` bit for bit: the key from a
seed, the fold-like split, 64 random bits, and ``randint`` to int64 with its
two-word reduction, for six seeds (two of them at or above 2^32, which fill
the key's high word) and bounds near 2^60 and 2^40 (where JAX's wrapping
multiplier vanishes), near 2^31 and small, and the signed flood range. Then
``threshold.common_random_poly`` gives the JAX package's CRS residues at
N=256 (radix-2 and four-step order) and at N=2^14 on the reference chain,
where the SHA-256 of the residues is the constant ``chip_smoke.py``
asserts on the card."""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from ppqsflhe_tpu.ckks import threshold as jth
from ppqsflhe_tpu.ckks.params import CkksContext as JaxContext
from ppqsflhe_tpu.ckks.params import CkksParams as JaxParams
from ppqsflhe_tpu.core import primes
from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.ckks import threshold as th
from ppqsflhe_tpu_torch.ckks.params import CkksContext
from ppqsflhe_tpu_torch.core import jax_prng

SEEDS = [0, 1, 20261017, (1 << 32) - 1, (7 << 32) | 2026, (1 << 63) - 1]
BOUNDS = [(0, primes.first_prime_down(60, 1 << 15)), (0, primes.first_prime_down(40, 1 << 15)),
          (0, (1 << 31) + 11), (0, 1000), (-(1 << 30), (1 << 30) + 1), (-1, 2)]


def test_replays_the_partitionable_layout():
    """The replay is of jax_threefry_partitionable = True, this jax's
    default; the other layout gives other bits."""
    assert jax.__version__ == "0.9.0"
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split(seed):
    k = jax.random.PRNGKey(seed)
    key = jax_prng.prng_key(seed)
    assert np.array_equal(np.asarray(k), key)
    for num in (2, 5):
        assert np.array_equal(np.asarray(jax.random.split(k, num)), jax_prng.split(key, num))


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits(seed):
    k = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.bits(k, (257,), jnp.uint64))
    assert np.array_equal(want, jax_prng.random_bits64(jax_prng.prng_key(seed), 257))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_int64(seed):
    k = jax.random.PRNGKey(seed)
    for lo, hi in BOUNDS:
        want = np.asarray(jax.random.randint(k, (300,), lo, hi, dtype=jnp.int64))
        got = jax_prng.randint64(jax_prng.prng_key(seed), 300, lo, hi)
        assert np.array_equal(want, got), (lo, hi)


@pytest.mark.parametrize("backend", ["radix2", "fourstep"])
def test_common_random_poly_n256(backend):
    jp = JaxParams.generate(n=256, mult_depth=2, scale_bits=40, dnum=2, ntt_backend=backend,
                            ntt_impl="mxu" if backend == "fourstep" else "xla")
    jctx = JaxContext(jp)
    ctx = CkksContext(convert.params(dataclasses.asdict(jp)))
    for seed in (3, (1 << 40) + 5, -1):
        want = np.asarray(jth.common_random_poly(jctx, seed))
        got = convert.residues_np(th.common_random_poly(ctx, seed, "cpu"))
        assert np.array_equal(want, got), seed


def test_common_random_poly_reference_chain():
    """N=2^14 on ``generate(n=2^14, mult_depth=2, scale_bits=40, dnum=2)``
    (four-step order, as the chip phase runs it): bit-equal, and the hash
    the chip phase asserts."""
    jp = JaxParams.generate(n=1 << 14, mult_depth=2, scale_bits=40, dnum=2,
                            ntt_backend="fourstep", ntt_impl="mxu")
    want = np.asarray(jth.common_random_poly(JaxContext(jp), chip_smoke.CRS_SEED))
    ctx = CkksContext(convert.params(dataclasses.asdict(jp)))
    got = convert.residues_np(th.common_random_poly(ctx, chip_smoke.CRS_SEED, "cpu"))
    assert np.array_equal(want, got)
    assert hashlib.sha256(want.astype("<u8").tobytes()).hexdigest() == chip_smoke.CRS_SHA256
