"""Kernel 7's shape rules and shared-memory layout, on the CPU.

``csrc/overlap_probe.cu`` runs only on the card; what surrounds it is held
here: which (K, W, m, c) the wrapper passes to the kernel
(``check_kernel_shapes``), the split of each cell's rows over CTAs
(``cta_grid``), and a numpy twin of the producer warpgroup's transpose
(``transpose_step``: thread p's loads, ``__byte_perm`` selectors and stores),
held against the 128-byte swizzle that the wgmma descriptors name (start
address advanced 32 bytes per k32 slice, 8-row groups 1024 bytes apart), for
bit-equality with x ^ carry, for being a permutation of the B tile, and for
conflict-free shared-memory phases. The constants are parsed out of the
source so the twin cannot drift from it. ``check_chain``, which holds every
launch of a replayed chain to the plain version on the card, is held here
to plain chains and to chains with one stale or poisoned launch."""

import os
import re

import numpy as np
import pytest
import torch

from ppqsflhe_tpu_torch.ops import cuda_lib
from ppqsflhe_tpu_torch.probes import mxu_vpu_overlap as probe

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "ppqsflhe_tpu_torch", "csrc", "overlap_probe.cu")


def _source():
    with open(SRC) as f:
        return f.read()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _source()).group(1))


def _byte_perm(x, y, s):
    """CUDA's __byte_perm(x, y, s) (default mode) on numpy uint32 arrays."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint64)
    for i in range(4):
        sel = ((s >> np.uint32(4 * i)) & np.uint32(7)).astype(np.uint64)
        out |= ((both >> (np.uint64(8) * sel)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _swizzle128(addr):
    """The 128-byte swizzle on a byte offset from a 1024-aligned tile: the
    16-byte chunk index (bits 4-6) XOR the row within the 8-row group (bits
    7-9)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _transpose_twin(raw, carry):
    """What the producer's 128 threads store for one staged step: (B tile
    bytes, store addresses as (phase, lane) → 16-byte offset, load word
    offsets as (instruction, lane))."""
    kc = _const("KC")
    words = raw.reshape(-1).view("<u4")                   # raw[k][n], rows of KC bytes
    b = np.full(kc * kc, -1, dtype=np.int64)
    stores, loads = [], []
    p = np.arange(128, dtype=np.uint32)
    q = p & np.uint32(31)
    r = (q >> np.uint32(1)) & np.uint32(3)
    r1, r2, r3 = (r + 1) & 3, (r + 2) & 3, (r + 3) & 3
    sa = r | ((4 + r) << 4) | (r1 << 8) | ((4 + r1) << 12)
    sb = r2 | ((4 + r2) << 4) | (r3 << 8) | ((4 + r3) << 12)
    carry4 = np.uint32((carry & 0xFF) * 0x01010101)
    for u in range(2):
        g = (p >> np.uint32(5)) + np.uint32(4 * u)
        o = np.zeros((4, 4, 128), dtype=np.uint32)
        for mq in range(4):
            w = []
            for i in range(4):
                off = (16 * g + 4 * mq + i) * kc + 4 * q
                loads.append(off)
                w.append(words[off // 4] ^ carry4)
            t0, t1 = _byte_perm(w[0], w[1], sa), _byte_perm(w[2], w[3], sa)
            t2, t3 = _byte_perm(w[0], w[1], sb), _byte_perm(w[2], w[3], sb)
            o[0, mq] = _byte_perm(t0, t1, np.uint32(0x5410))
            o[1, mq] = _byte_perm(t0, t1, np.uint32(0x7632))
            o[2, mq] = _byte_perm(t2, t3, np.uint32(0x5410))
            o[3, mq] = _byte_perm(t2, t3, np.uint32(0x7632))
        for s in range(4):
            n = 4 * q + ((s + r) & 3)
            addr = n * kc + ((g ^ (n & 7)) << 4)
            stores.append(addr)
            data = o[s].T.copy().view(np.uint8).reshape(128, 16)   # 4 words per thread
            for lane in range(128):
                assert (b[addr[lane] : addr[lane] + 16] == -1).all(), "a byte stored twice"
                b[addr[lane] : addr[lane] + 16] = data[lane]
    return b, np.array(stores), np.array(loads)


@pytest.mark.parametrize("K,W,m,c", [(64, 1536, 256, 256), (1, 128, 128, 256),
                                     (3, 512, 384, 256), (2, 1024, 1024, 256)])
def test_kernel_takes_shape(K, W, m, c):
    probe.check_kernel_shapes(K, W, m, c)


@pytest.mark.parametrize("K,W,m,c", [(64, 1536, 256, 128), (64, 1536, 64, 256),
                                     (64, 1536, 192, 256), (64, 1600, 256, 256),
                                     (4, 128, 256, 256), (0, 1536, 256, 256),
                                     (64, 1536, 0, 256)])
def test_kernel_refuses_shape(K, W, m, c):
    with pytest.raises(ValueError, match="probe kernel needs"):
        probe.check_kernel_shapes(K, W, m, c)


def test_wrapper_refuses_before_building():
    """A shape the kernel does not take, or an A that does not match x8,
    raises in the wrapper before the library is built."""
    x8 = torch.zeros((2, 192, 256), dtype=torch.int8)
    a = torch.zeros((192, 192), dtype=torch.int8)
    with pytest.raises(ValueError, match="probe kernel needs"):
        probe._launch(0, x8, a, None, 192)
    with pytest.raises(ValueError, match="probe kernel needs a"):
        probe._launch(0, torch.zeros((2, 256, 256), dtype=torch.int8), a, None, 128)
    assert cuda_lib._lib is None


def _small_world():
    rng = np.random.default_rng(3)
    x8 = torch.from_numpy(rng.integers(0, 100, (2, 256, 256), dtype=np.int8))
    a = torch.from_numpy(rng.integers(-100, 100, (256, 256), dtype=np.int8))
    return x8, a


@pytest.mark.parametrize("kind", probe.KINDS)
def test_check_chain_takes_the_plain_chain(kind):
    """The outputs of chained plain calls from carry 0 pass the check that
    ``chained_ms`` applies to every launch of a replayed chain, and the
    carry moves along the chain."""
    x8, a = _small_world()
    outs = []
    for _ in range(6):
        outs.append(probe.probe_plain(kind, x8, a, outs[-1] if outs else None, 128))
    probe.check_chain(kind, x8, a, outs, 128)
    assert len({probe.carry_byte(o) for o in outs}) > 1 or kind == "mxu"


@pytest.mark.parametrize("bad", [0, 3, 5])
def test_check_chain_refuses_a_stale_or_poisoned_launch(bad):
    """One launch whose output was left stale (the previous one's) or
    poisoned fails the chain check, whichever launch it is."""
    x8, a = _small_world()
    outs = []
    for _ in range(6):
        outs.append(probe.probe_plain("serial", x8, a, outs[-1] if outs else None, 128))
    for stale in (outs[bad - 1].clone() if bad else None,
                  torch.full_like(outs[bad], probe.POISON)):
        if stale is None:
            continue
        tampered = outs[:bad] + [stale] + outs[bad + 1:]
        with pytest.raises(AssertionError, match=f"chained launch {bad + 1} of 6"):
            probe.check_chain("serial", x8, a, tampered, 128)


def test_python_constants_match_the_source():
    assert (probe.BM, probe.KC) == (_const("BM"), _const("KC"))
    assert _const("THREADS") == 128 * sum(probe.WARPGROUPS.values())
    assert _const("PRODUCER") == 128 * probe.WARPGROUPS["consumer"]


def test_shared_memory_fits_and_tiles_align():
    """Every ring stage starts 1024-aligned (the swizzle's period), and the
    rings and barriers fit the 227 KB a block may take."""
    bm, kc, os_, rs = _const("BM"), _const("KC"), _const("OS"), _const("RS")
    assert "constexpr int TILE = BM * KC;" in _source()
    tile = bm * kc
    assert tile % 1024 == 0 and (64 * kc) % 1024 == 0
    assert os_ >= 2 and rs >= 3
    smem = (2 * os_ + rs) * tile + (2 * os_ + rs) * 8 + 1024
    assert smem <= 232448
    assert "constexpr int SMEM = (2 * OS + RS) * TILE + (2 * OS + RS) * 8 + 1024;" in _source()


def test_descriptor_fields():
    """The descriptor names the 128-byte swizzle (layout type 1 in bits
    62-63) with 8-row groups 1024 bytes apart (SBO = 64 in 16-byte units in
    bits 32-45), as the producer and the TMA copy of A lay the tiles out."""
    body = re.search(r"uint64_t desc_b128\(uint32_t addr\) \{(.*?)\}", _source(), re.S).group(1)
    assert "(addr & 0x3FFFF) >> 4" in body
    assert "(64ull << 32)" in body and "(1ull << 62)" in body
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in _source()


def test_cta_grid_covers_each_row_once():
    for K, m in ((64, 256), (3, 384), (1, 128)):
        grid = probe.cta_grid(K, m)
        assert len(grid) == K * m // probe.BM
        rows = {(cell, row0 + i) for cell, row0 in grid for i in range(probe.BM)}
        assert rows == {(cell, r) for cell in range(K) for r in range(m)}
        nb = m // probe.BM
        for b, (cell, row0) in enumerate(grid):       # a cell's CTAs are adjacent
            assert cell == b // nb and row0 == (b % nb) * probe.BM


@pytest.mark.parametrize("carry", [0, 0x1A5, 0x7F])
def test_transpose_twin_fills_the_swizzled_b_tile(carry):
    """The producer's stores fill the B tile exactly once, and byte (n, k) of
    what the wgmma reads at logical offset (n // 8) * 1024 + (n % 8) * 128 +
    k (through the swizzle) is x[k][n] ^ carry: for every k32 slice kk the
    descriptor's start advanced by 32 * kk reads bytes 32 kk .. 32 kk + 31."""
    kc = _const("KC")
    rng = np.random.default_rng(carry)
    raw = rng.integers(0, 256, (kc, kc), dtype=np.uint8)
    b, _, _ = _transpose_twin(raw, carry)
    assert (b >= 0).all()
    want = raw ^ np.uint8(carry & 0xFF)
    for kk in range(kc // 32):
        n = np.arange(kc)[:, None]
        kb = np.arange(32)[None, :]
        logical = (n // 8) * 1024 + (n % 8) * 128 + 32 * kk + kb
        np.testing.assert_array_equal(b[_swizzle128(logical)], want[32 * kk + kb, n])


def test_transpose_twin_is_conflict_free():
    """Each 4-byte load instruction of a warp reads 32 distinct banks; each
    8-lane phase of a 16-byte store meets 8 distinct 16-byte slots of a
    128-byte line; the stores are a permutation of the tile's 16-byte
    chunks."""
    kc = _const("KC")
    raw = np.zeros((kc, kc), dtype=np.uint8)
    _, stores, loads = _transpose_twin(raw, 0)
    for ins in loads:
        for warp in range(4):
            banks = (ins[32 * warp : 32 * warp + 32] // 4) % 32
            assert len(set(banks.tolist())) == 32
    for ins in stores:
        for ph in range(16):
            slots = (ins[8 * ph : 8 * ph + 8] // 16) % 8
            assert len(set(slots.tolist())) == 8
    chunks = np.sort(np.concatenate(stores) // 16)
    np.testing.assert_array_equal(chunks, np.arange(kc * kc // 16))
