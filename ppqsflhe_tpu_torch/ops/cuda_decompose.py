"""The key switch's digit tensor on the card: each digit's own-group rows
times [Q̂_j⁻¹]_{q_i}, its extension to the other limbs around them, every
digit stacked in the layout the inner product (kernel 3) reads.

Replaces no TPU kernel: the JAX package's ``ckks/eval.py``
``keyswitch_core`` leaves the Shoup product, each digit's concatenation and
their stack to XLA, which fused them into their neighbours. In torch ops
(:func:`digits_plain`) that is ≈31 int64 launches over the group's rows, a
``torch.cat`` a digit and a ``torch.stack``. The kernel
(``csrc/decompose.cu``) writes each digit's rows once into one preallocated
``(B, nd, LK, N)`` tensor, reading c or the extension once, so it is bound
by 2 × B × nd × LK × N × 8 bytes at 3.35 TB/s: 16-byte accesses, a
(coefficient block, extended row, batch) grid whose blocks take their branch
and constants from the row, and c read in place through its strides.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel, one
launch a digit, or raises. The constants are the context's cached device
columns (``CkksContext.consts``): nothing is uploaded and the launches go on
the tensor's current stream, so a CUDA-graph capture takes them.
"""

from __future__ import annotations

import math

import torch

from ..core.modarith import shoup_mul
from . import cuda_lib

# digits the kernel assembled: eager launches and captures (a graph's
# replays are not counted; utils/graphs.COUNTERS does not list this one)
launches = 0


def digits_plain(c, exts, spans, w, ws, q):
    """c: int64[..., l, N] eval-domain residues; for digit j, ``exts[j]``:
    int64[..., LK − (hi − lo), N], its extension to the other limbs of the
    extended basis, eval domain; ``spans[j]`` = (lo, hi), its group's rows;
    ``w[j]``, ``ws[j]``, ``q[j]``: int64 (hi − lo, 1), [Q̂_j⁻¹]_{q_i}, its
    Shoup companion and q_i. → int64[..., nd, LK, N]."""
    return torch.stack([torch.cat([e[..., :lo, :], shoup_mul(c[..., lo:hi, :], wj, wsj, qj),
                                   e[..., lo:, :]], dim=-2)
                        for e, (lo, hi), wj, wsj, qj in zip(exts, spans, w, ws, q)], dim=-3)


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0 and all(s % 2 == 0 for s in t.stride()[:-1])


def _layout(c, exts, spans, w, ws, q):
    """Check the operands against what the kernel takes, on either device:
    → (c as (Bf, l, N), in place wherever the batch dimensions merge into
    one stride; the extensions as contiguous (Bf, rows, N); LK). Raises
    ValueError."""
    lead, (l, n) = c.shape[:-2], c.shape[-2:]
    nd = len(exts)
    if not (nd == len(spans) == len(w) == len(ws) == len(q)) or nd == 0:
        raise ValueError(f"decompose: {nd} extensions, {len(spans)} groups, {len(w)}, "
                         f"{len(ws)}, {len(q)} constant columns")
    if c.dtype != torch.int64:
        raise ValueError(f"decompose c: expected int64, got {c.dtype}")
    lk = exts[0].shape[-2] + spans[0][1] - spans[0][0]
    for e, (lo, hi), cols in zip(exts, spans, zip(w, ws, q)):
        if (e.shape != lead + (lk - (hi - lo), n) or e.dtype != torch.int64
                or e.device != c.device or not 0 <= lo < hi <= l):
            raise ValueError(f"decompose: extension {tuple(e.shape)} {e.dtype} on {e.device} "
                             f"for the group rows {lo}:{hi} of c {tuple(c.shape)} on "
                             f"{c.device}, {lk} extended limbs")
        for name, t in zip(("w", "w_sh", "q"), cols):
            if (t.numel() != hi - lo or t.dtype != torch.int64 or t.device != c.device
                    or not t.is_contiguous()):
                raise ValueError(f"decompose: {name} {tuple(t.shape)} {t.dtype} on {t.device} "
                                 f"for the group rows {lo}:{hi} on {c.device}")
    bf = math.prod(lead)
    cb = c.reshape(bf, l, n)
    ebs = [e.reshape(bf, e.shape[-2], n).contiguous() for e in exts]
    if n % 2 or cb.stride(-1) != 1 or not all(map(_aligned, [cb] + ebs)):
        raise ValueError(f"decompose needs an even N, unit coefficient stride, even batch and "
                         f"limb strides and 16-byte alignment; got N={n}, strides "
                         f"{cb.stride()}, address {cb.data_ptr():#x}")
    return cb, ebs, lk


def digits(c: torch.Tensor, exts, spans, w, ws, q) -> torch.Tensor:
    """Same contract as :func:`digits_plain`, with the kernel's checks on
    either device; launches the kernel for CUDA tensors. ``c`` may be a view
    with any batch and limb strides (the ciphertext's ``data[..., 1, :, :]``);
    the result is contiguous."""
    global launches
    cb, ebs, lk = _layout(c, exts, spans, w, ws, q)
    if not c.is_cuda:
        return digits_plain(c, exts, spans, w, ws, q)
    nd, n = len(exts), c.shape[-1]
    out = torch.empty((cb.shape[0], nd, lk, n), dtype=torch.int64, device=c.device)
    if out.numel():
        lib = cuda_lib.library()
        with torch.cuda.device(c.device):
            for j, (eb, (lo, hi), wj, wsj, qj) in enumerate(zip(ebs, spans, w, ws, q)):
                code = lib.ppq_decompose_digit(
                    cb.data_ptr(), eb.data_ptr(), out.data_ptr(), qj.data_ptr(), wj.data_ptr(),
                    wsj.data_ptr(), cb.stride(0), cb.stride(1), cb.shape[0], nd, j, lo, hi, lk,
                    n, cuda_lib.stream_of(cb))
                launches += 1
                cuda_lib.check(code, "ppq_decompose_digit")
    return out.reshape(c.shape[:-2] + (nd, lk, n))
