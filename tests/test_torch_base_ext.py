"""Kernel 2 (``csrc/base_ext.cu``) redesigned: a numpy ``uint64`` model of the
kernel's per-thread arithmetic — the Shoup products on the constants of the
``ExtParams`` struct the wrapper passes, the Q0.64 alpha, the deferred
destination sums and their reduction chain, the dst chunks — against the
plain ``BaseExtender.extend`` and the JAX package's ``fused_extend`` in
interpret mode, at every unrolled (ls, ld) instance and the generic one,
with and without the folded digit constant, on inputs holding 0 and q − 1;
the struct's layout and instance list against the kernel source; the
launcher's refusals. Exact residues, tolerance 0."""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppqsflhe_tpu.core.rns import BaseExtender as JaxExtender
from ppqsflhe_tpu.ops.pallas_ext import fused_extend as jax_fused_extend
from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.core import primes
from ppqsflhe_tpu_torch.core.rns import BaseExtender
from ppqsflhe_tpu_torch.ops import cuda_ext, cuda_lib

N = 256
SRC = Path(cuda_lib.CSRC / "base_ext.cu").read_text()
# 60- and 40-bit moduli: src and dst bases drawn from both, as in the chains
MODULI = primes.prime_chain(60, 9, 2 * N) + primes.prime_chain(40, 9, 2 * N)
M32, S32 = np.uint64(0xFFFFFFFF), np.uint64(32)


def _mulhi(a, b):
    """High 64 bits of the 128-bit product, from 32-bit halves (__umul64hi)."""
    a0, a1, b0, b1 = a & M32, a >> S32, b & M32, b >> S32
    ll, lh, hl = a0 * b0, a0 * b1, a1 * b0
    mid = (ll >> S32) + (lh & M32) + (hl & M32)
    return a1 * b1 + (lh >> S32) + (hl >> S32) + (mid >> S32)


def _shoup_lazy(a, w, ws, q):
    return a * w - _mulhi(a, ws) * q


def _shoup(a, w, ws, q):
    r = _shoup_lazy(a, w, ws, q)
    return np.where(r >= q, r - q, r)


def _reduce(s, p, bound):
    """The kernel's reduce<bound>: s < bound·p → s mod p."""
    assert (s < np.uint64(bound) * p).all()
    for k in (8, 4, 2, 1):
        if bound > k:
            s = np.where(s >= np.uint64(k) * p, s - np.uint64(k) * p, s)
    assert (s < p).all()
    return s


def _model_launch(x, prm):
    """One launch of the kernel, per coefficient: x uint64 (Bf, ls, n) →
    (Bf, prm.ld, n). The reduction chain is the instance's: ls bounds it
    in an unrolled instance, MAX_SRC in the generic one; an unrolled instance
    adds ls·p − alpha·[D]_p to the unreduced sum, the generic one subtracts
    the strict Shoup product of alpha from the reduced sum."""
    u = lambda v: np.uint64(v)
    ls, ld = prm.ls, prm.ld
    unrolled = (ls, ld) in cuda_ext.INSTANCES
    with np.errstate(over="ignore"):
        y = [_shoup(x[:, i], u(prm.c[i]), u(prm.c_sh[i]), u(prm.q[i])) for i in range(ls)]
        acc = np.zeros_like(x[:, 0])
        carry = np.zeros_like(acc)
        for i in range(ls):
            nxt = acc + y[i] * u(prm.recip[i])                # wrapping Q0.64 sum
            carry += (nxt < acc).astype(np.uint64)
            acc = nxt
        alpha = carry + (acc >> np.uint64(63))
        out = []
        for j in range(ld):
            p = u(prm.p[j])
            s = np.zeros_like(acc)
            for i in range(ls):
                t = _shoup_lazy(y[i], u(prm.w[j][i]), u(prm.w_sh[j][i]), p)
                assert (t < 2 * p).all()
                s += t
            assert (s < 2 * ls * p).all() and (alpha <= ls).all()
            if unrolled:
                s = s + u(ls) * p - alpha * u(prm.dc[j])
                out.append(_reduce(s, p, 3 * ls))
            else:
                s = _reduce(s, p, 2 * cuda_ext.MAX_SRC)
                corr = _shoup(alpha, u(prm.dc[j]), u(prm.dc_sh[j]), p)
                out.append(np.where(s >= corr, s - corr, s + p - corr))
    return np.stack(out, axis=1)


def _model(x, ext, pre):
    """Every chunk's launch, the dst rows side by side."""
    return np.concatenate([_model_launch(x, prm) for _, prm in cuda_ext.ext_params(ext, pre)],
                          axis=1)


def _case(ls, ld, seed):
    """A src/dst basis split, inputs (2, ls, N) with 0 and q − 1 planted, and
    a digit constant per src limb."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(MODULI))
    src, dst = [MODULI[i] for i in idx[:ls]], [MODULI[i] for i in idx[ls:ls + ld]]
    x = np.stack([rng.integers(0, q, size=(2, N), dtype=np.uint64) for q in src], axis=1)
    for i, q in enumerate(src):
        x[0, i, :4] = 0
        x[1, i, :4] = q - 1
        x[0, i, 4:8] = q - 1
    pre = [int(rng.integers(1, q)) for q in src]
    return src, dst, x, pre


GENERIC = [(4, 2)]
SHAPES = list(cuda_ext.INSTANCES) + GENERIC


@pytest.mark.parametrize("fold", [False, True], ids=["plain", "pre"])
@pytest.mark.parametrize("ls,ld", SHAPES, ids=[f"{a}to{b}" for a, b in SHAPES])
def test_kernel_model_matches_plain_and_pallas_interpret(ls, ld, fold):
    src, dst, x, pre = _case(ls, ld, seed=10 * ls + ld)
    pre = pre if fold else None
    ext = BaseExtender(src, dst)
    chunks = cuda_ext.ext_params(ext, pre)
    assert len(chunks) == 1 and (chunks[0][1].ls, chunks[0][1].ld) == (ls, ld)
    got = _model(x, ext, pre)
    want = convert.residues_np(ext.extend(convert.residues(x, "cpu"), pre))
    np.testing.assert_array_equal(got, want)
    jax_out = jax_fused_extend(jnp.asarray(x), JaxExtender(src, dst), pre=pre, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(jax_out))


@pytest.mark.parametrize("ls,ld", [(2, 10), (8, 8), (3, 15)], ids=["2to10", "8to8", "3to15"])
def test_kernel_model_in_dst_chunks_matches_plain(ls, ld):
    """More than MAX_DST dst limbs run in chunks of at most MAX_DST, each
    its own struct (the generic instance, or an unrolled one for a short
    last chunk); MAX_SRC src limbs at once."""
    src, dst, x, pre = _case(ls, ld, seed=ls + ld)
    ext = BaseExtender(src, dst)
    chunks = cuda_ext.ext_params(ext, pre)
    assert [j0 for j0, _ in chunks] == list(range(0, ld, cuda_ext.MAX_DST))
    assert sum(prm.ld for _, prm in chunks) == ld
    want = convert.residues_np(ext.extend(convert.residues(x, "cpu"), pre))
    np.testing.assert_array_equal(_model(x, ext, pre), want)


def test_params_struct_matches_kernel_source():
    """ExtParams' fields, in order, with the kernel's sizes (MAX_SRC /
    MAX_DST from the source), and the unrolled instances are the source's
    PPQ_EXT_INSTANCES."""
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (MAX_\w+) = (\d+);", SRC)}
    assert (consts["MAX_SRC"], consts["MAX_DST"]) == (cuda_ext.MAX_SRC, cuda_ext.MAX_DST)
    body = re.search(r"struct ExtParams \{(.*?)\};", SRC, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.fullmatch(r"uint64_t (\w+)((?:\[\w+\])+);", line)
        if m:
            fields.append((m.group(1), 8 * int(np.prod([consts[d] for d in
                                                        re.findall(r"\[(\w+)\]", m.group(2))]))))
        else:
            ints = re.fullmatch(r"int (.+);", line).group(1)
            fields += [(name.strip(), 4) for name in ints.split(",")]
    ours = [(name, ctypes.sizeof(t)) for name, t in cuda_ext.ExtParams._fields_]
    assert ours == fields
    assert [getattr(cuda_ext.ExtParams, name).offset for name, _ in ours] == \
        list(np.cumsum([0] + [size for _, size in fields[:-1]]))
    assert ctypes.sizeof(cuda_ext.ExtParams) == 1480
    line = re.search(r"#define PPQ_EXT_INSTANCES\(X\)(.*?)\n\n", SRC, re.S).group(1)
    assert tuple((int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", line)) == \
        cuda_ext.INSTANCES


def test_launcher_refuses_before_building():
    """More than MAX_SRC src limbs raise in the struct builder (so nothing
    can launch them: the launcher takes only structs of its input's shape);
    a CPU tensor raises in the launcher (fused_extend gives it to the plain
    version); nothing builds and the counter stays."""
    before = cuda_ext.launches
    src, dst, x, _ = _case(2, 3, seed=1)
    big = BaseExtender(MODULI[:9], MODULI[9:11])
    with pytest.raises(ValueError, match="at most 8 src limbs"):
        cuda_ext.ext_params(big)
    small = cuda_ext.ext_params(BaseExtender(MODULI[:8], MODULI[9:11]))
    with pytest.raises(ValueError, match="other shapes"):
        cuda_ext.base_extend(torch.zeros((1, 9, N), dtype=torch.int64), small, 2)
    ext = BaseExtender(src, dst)
    with pytest.raises(ValueError, match="other shapes"):
        cuda_ext.base_extend(convert.residues(x, "cpu"), cuda_ext.ext_params(ext), 4)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ext.base_extend(convert.residues(x, "cpu"), cuda_ext.ext_params(ext), 3)
    got = cuda_ext.fused_extend(convert.residues(x, "cpu"), ext)
    assert torch.equal(got, ext.extend(convert.residues(x, "cpu")))
    assert cuda_ext.launches == before
    assert cuda_lib._lib is None
