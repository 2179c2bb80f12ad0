"""Kernel 6 (``csrc/fourstep_ntt.cu``) as register-blocked Shoup butterflies:
the CUDA kernel's schedule, modelled step for step on the CPU over the
tables ``CudaFourStepNtt.device`` uploads, against the plain transform
(``ntt_body_cg`` / ``intt_body_cg``) and, at N = 2^10 and 2^12, against the
JAX package's ``FourStepNtt(implementation="pallas")`` in interpret mode;
and the launcher's refusals. Exact residues, tolerance 0, on a 60/40-bit
chain (inputs < 4q forward, < 2q inverse)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_streamed_ntt import _high, _labels, _low

from ppqsflhe_tpu.ops.pallas_ntt import FourStepNtt as JaxFourStepNtt
from ppqsflhe_tpu_torch.core import primes
from ppqsflhe_tpu_torch.core.modarith import shoup_mul, shoup_mul_lazy
from ppqsflhe_tpu_torch.ops import cuda_lib, cuda_ntt
from ppqsflhe_tpu_torch.ops.cuda_ntt import CudaFourStepNtt


def _t(a):
    return torch.from_numpy(np.array(a, np.uint64, order="C").view(np.int64))


def _u(t):
    return t.numpy().view(np.uint64)


@functools.lru_cache(maxsize=None)
def _ring(n):
    moduli = [primes.first_prime_down(60, 2 * n)] + primes.prime_chain(40, 1, 2 * n)
    psis = [primes.root_of_unity(2 * n, q) for q in moduli]
    return moduli, psis, CudaFourStepNtt(n, moduli, psis)


def _model_tile(x, buf, info, fwd, first, c0):
    """One block of kernel 6: columns [c0, c0 + TC) of one limb's x (B, m, c),
    TC = min(c, 16). Thread (t, cc) holds rows t + T·k of column cc (k < R:
    R = 16, or m at m ≤ 16, where there is no exchange); forward pass 1
    twists them by the (m, c) table read from global memory; four stages on
    those labels, one exchange to rows 16·t + k, the rest there (the
    inverse the other way round), twiddles from Pease row 0 of the stage
    table; then the post table tile (lazy twiddle, lazy inverse twiddle,
    strict itwist) or forward pass 2's csub. Pass 1 returns the block's run
    of y (B, TC, m), written through the tile transposed; pass 2 (B, m, TC)."""
    B, m, c = x.shape
    logm, (T, R, hi, lo), h, tc = m.bit_length() - 1, _labels(m), m // 2, min(c, 16)
    q, size = int(info[0]), m * c
    stage = buf[int(info[3]):]
    rw, rs = stage[:h], stage[logm * h:logm * h + h]      # Pease row 0: root^i
    pair = lambda off: buf[int(off):int(off) + 2 * size].view(2, m, c)[..., c0:c0 + tc]
    tile = x[..., c0:c0 + tc].clone()
    if fwd:
        v = tile[:, hi]
        if first:
            pre = pair(info[1])
            v = shoup_mul_lazy(v, pre[0][hi], pre[1][hi], q)
        _high(v, T, rw, rs, q, True)
        tile[:, hi] = v
        v = tile[:, lo]
        _low(v, logm, rw, rs, q, True)
        labels = lo
    else:
        v = tile[:, lo]
        _low(v, logm, rw, rs, q, False)
        tile[:, lo] = v
        v = tile[:, hi]
        _high(v, T, rw, rs, q, False)
        labels = hi
    if fwd and not first:
        v = torch.where(v >= q, v - q, v)
    else:
        post = pair(info[2])
        mul = shoup_mul_lazy if first else shoup_mul
        v = mul(v, post[0][labels], post[1][labels], q)
    if not first:
        out = torch.empty_like(tile)
        out[:, labels] = v
        return out
    tile_t = torch.empty((B, tc, m), dtype=v.dtype)
    tile_t[:, :, labels] = v.permute(0, 3, 1, 2)       # (B, col, t, k) → [col][row]
    return tile_t


def _model_pass(x, buf, info, fwd, first):
    """The kernel's grid: every limb of x (B, L, m, c), every TC-column block."""
    return torch.stack([
        torch.cat([_model_tile(x[:, l], buf, info[l], fwd, first, c0)
                   for c0 in range(0, x.shape[-1], min(x.shape[-1], 16))],
                  dim=1 if first else 2)
        for l in range(x.shape[1])], dim=1)


def _model_transform(port, x, sel, fwd):
    """Both launches of a transform, x (B, L, N) → (B, L, N)."""
    buf, info1, info2 = port.device("cpu", sel, fwd)
    m1, m2 = (port.n1, port.n2) if fwd else (port.n2, port.n1)
    y = _model_pass(x.reshape(x.shape[0], len(sel), m1, m2), buf, info1, fwd, True)
    assert y.shape[-2:] == (m2, m1)
    return _model_pass(y, buf, info2, fwd, False).reshape(x.shape)


def _inputs(moduli, sel, n, fwd, seed):
    rng = np.random.default_rng(seed)
    k = 4 if fwd else 2
    return _t(np.stack([rng.integers(0, k * moduli[i], size=(2, n), dtype=np.uint64)
                        for i in sel], axis=1))


@pytest.mark.parametrize("n", [1 << 11, 1 << 15, 1 << 6, 1 << 7, 1 << 9],
                         ids=["m32_64", "m128_256", "m8", "m8_16", "m16_32"])
@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
def test_kernel_schedule_model_matches_plain(n, forward):
    """The schedule over the uploaded tables equals ntt_body_cg /
    intt_body_cg bit for bit, at m ∈ {32, 64} (N=2^11: n1=32, n2=64),
    {128, 256} (N=2^15) and the small rings' m = 8, 16 (N = 2^6, 2^7, 2^9:
    one thread a column, 8-wide tiles for the 8-column passes); each launch
    equals its plain pass (pass 1's lazy representative too)."""
    moduli, _, port = _ring(n)
    sel = [1, 0]
    x = _inputs(moduli, sel, n, forward, seed=n + forward)
    buf, info1, info2 = port.device("cpu", sel, forward)
    m1, m2 = (port.n1, port.n2) if forward else (port.n2, port.n1)
    xb = x.reshape(2, len(sel), m1, m2)
    y = _model_pass(xb, buf, info1, forward, True)
    assert torch.equal(y, port.plain_pass(xb, forward, True, sel))
    z = _model_pass(y, buf, info2, forward, False)
    assert torch.equal(z, port.plain_pass(y, forward, False, sel))
    assert torch.equal(z.reshape(x.shape), port.plain(x, forward, sel))


def test_kernel_schedule_model_at_m256_both_passes():
    """N=2^16: both passes at m=256, both directions, and back to the input."""
    n = 1 << 16
    moduli, _, port = _ring(n)
    sel = [0]
    x = _inputs(moduli, sel, n, False, seed=3)[:1] % moduli[0]
    y = _model_transform(port, x, sel, True)
    assert torch.equal(y, port.plain(x, True, sel))
    assert torch.equal(_model_transform(port, y, sel, False), x)


@pytest.mark.parametrize("n", [1 << 10, 1 << 12], ids=["n1024", "n4096"])
def test_kernel_schedule_model_matches_pallas_interpret(n):
    """The modelled kernel equals the JAX Pallas transform in interpret mode,
    forward and inverse, over a limb subset."""
    moduli, psis, port = _ring(n)
    sel = [1, 0]
    x = _inputs(moduli, sel, n, False, seed=n) % _t(np.array(moduli, np.uint64)[sel])[:, None]
    jax_ntt = JaxFourStepNtt(n, moduli, psis)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_ntt.ntt(jnp.asarray(_u(x)), implementation="pallas", idx=sel))
        back = np.asarray(jax_ntt.intt(jnp.asarray(want), implementation="pallas", idx=sel))
    np.testing.assert_array_equal(back, _u(x))
    got = _model_transform(port, x, sel, True)
    np.testing.assert_array_equal(_u(got), want)
    np.testing.assert_array_equal(_u(_model_transform(port, got, sel, False)), back)


def test_fourstep_pass_refuses_unsupported_shapes_and_cpu_tensors():
    """Kernel 6 takes m ∈ {8, 16, …, 256} and whole 16-column tiles (8
    columns at m ≤ 16), on CUDA tensors only: each refusal raises before any
    build or launch (an unsupported m before the device is looked at), and
    the counter stays."""
    before = cuda_ntt.launches
    tabs, info = torch.zeros(8, dtype=torch.int64), torch.zeros((1, 4), dtype=torch.int64)
    for m, c, match in ((4, 32, "m in"), (512, 32, "m in"), (96, 32, "m in"), (2, 32, "m in"),
                        (32, 40, "tiles"), (64, 32, "CUDA"), (256, 256, "CUDA")):
        x = torch.zeros((1, 1, m, c), dtype=torch.int64)
        for forward in (True, False):
            for first in (True, False):
                y = torch.zeros((1, 1, c, m) if first else (1, 1, m, c), dtype=torch.int64)
                with pytest.raises(ValueError, match=match):
                    cuda_ntt.fourstep_pass(x, y, tabs, info, forward, first)
    assert cuda_ntt.launches == before
    assert cuda_lib._lib is None
