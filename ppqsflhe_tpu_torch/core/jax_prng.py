"""A numpy replay of ``jax.random``'s threefry draws, bit for bit.

The threshold protocol's common random polynomial (CRS) is a deterministic
function of a shared seed: the JAX package draws it as
``uniform_rns(PRNGKey(seed & 0x7FFF_FFFF_FFFF_FFFF), moduli, n)``
(``ppqsflhe_tpu/ckks/threshold.py:98-103``), i.e. ``split(key, L)`` and, per
limb, ``randint(k, (n,), 0, q, int64)``. A JAX party and a port party can
share one joint key only if both derive the same residues, and the port
must not import JAX, so this module replays those draws in vectorised
numpy uint32 / uint64 arithmetic. It replays jax 0.9.0 with
``jax_threefry_partitionable = True`` (that release's default):

- ``PRNGKey``: ``threefry_seed`` (``jax/_src/prng.py:802``) — the 64-bit
  seed's high and low words;
- the Threefry-2x32 hash, 20 rounds (``threefry_2x32``, ``:1092``);
- ``split``: the fold-like split (``:1156``), the hash of the counters
  (0, i);
- 64 random bits: ``_threefry_random_bits_partitionable`` (``:1184``),
  (hi << 32) | lo of the hash of (0, i);
- ``randint`` to int64: the two-word reduction of ``_randint``
  (``jax/_src/random.py:581-657``), with JAX's wrapping uint64 multiplier
  (2^32 mod span)² mod span — which is 0 for spans above 2^32.

The older counter layout (``jax_threefry_partitionable = False``) gives
other bits that look just as uniform; only a bit-equality test against
``jax.random`` tells them apart. Every other draw of the port comes from a
``torch.Generator``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF


def _u32(v) -> np.ndarray:
    return np.asarray(v, dtype=np.uint32)


def threefry_2x32(key, x0, x1):
    """The Threefry-2x32 hash of counter pairs (x0, x1) under ``key`` (two
    uint32 words): a pair of uint32 arrays of x0's shape."""
    k0, k1 = _u32(key[0]), _u32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _u32(_PARITY))
    with np.errstate(over="ignore"):
        x = [_u32(x0) + ks[0], _u32(x1) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = (x[1] << _u32(r)) | (x[1] >> _u32(32 - r))
                x[1] = x[0] ^ x[1]
            x = [x[0] + ks[(i + 1) % 3], x[1] + ks[(i + 2) % 3] + _u32(i + 1)]
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2^63: (high, low) words."""
    if not 0 <= seed < 1 << 63:
        raise ValueError(f"seed {seed} outside [0, 2^63)")
    return _u32([(seed >> 32) & _M32, seed & _M32])


def _counter_hash(key, count: int):
    """The hash of the counters (i >> 32, i & 0xFFFFFFFF), i < count: the
    partitionable layout of a 1-D draw."""
    i = np.arange(count, dtype=np.uint64)
    return threefry_2x32(key, (i >> np.uint64(32)).astype(np.uint32),
                         (i & np.uint64(_M32)).astype(np.uint32))


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: uint32[num, 2]."""
    b0, b1 = _counter_hash(key, num)
    return np.stack([b0, b1], axis=1)


def random_bits64(key, n: int) -> np.ndarray:
    """64 random bits per entry of an (n,) draw: uint64[n]."""
    b0, b1 = _counter_hash(key, n)
    return (b0.astype(np.uint64) << np.uint64(32)) | b1.astype(np.uint64)


def randint64(key, n: int, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, (n,), minval, maxval, dtype=int64)``."""
    if not (-(1 << 63) <= minval and maxval < 1 << 63):
        raise ValueError("bounds outside int64")
    k_hi, k_lo = split(key, 2)
    higher, lower = random_bits64(k_hi, n), random_bits64(k_lo, n)
    span = np.asarray([(maxval - minval) % (1 << 64) if maxval > minval else 1],
                      dtype=np.uint64)
    with np.errstate(over="ignore"):
        mult = np.asarray([1 << 32], dtype=np.uint64) % span
        mult = (mult * mult) % span
        offset = ((higher % span) * mult + lower % span) % span
        return (np.int64(minval) + offset.view(np.int64)).astype(np.int64)


def uniform_rns(seed: int, moduli: Sequence[int], n: int) -> np.ndarray:
    """The JAX package's ``sampling.uniform_rns(PRNGKey(seed), moduli, n)``:
    uint64[len(moduli), n], limb i uniform below moduli[i]."""
    keys = split(prng_key(seed), len(moduli))
    return np.stack([randint64(k, n, 0, int(q)).view(np.uint64)
                     for k, q in zip(keys, moduli)])
