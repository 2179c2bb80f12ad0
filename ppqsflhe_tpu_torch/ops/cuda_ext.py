"""Kernel 2: the HPS fast base extension on the card.

Twin of :func:`ppqsflhe_tpu.ops.pallas_ext.fused_extend`: a drop-in for
``extender.extend(x)`` in the coefficient domain, optionally with per-src
constants ``pre`` folded into the first multiply (the key-switch digit
decomposition's [Q̂_j^{-1}]_{q_i}). A CPU tensor runs the plain
:meth:`..core.rns.BaseExtender.extend`; a CUDA tensor launches
``csrc/base_ext.cu``, its constants passed by value as one
:class:`ExtParams` struct per launch (built once per extender and ``pre``;
nothing is uploaded). A dst basis of more than :data:`MAX_DST` limbs runs
in chunks of at most that many, one launch each.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import primes
from ..core.rns import BaseExtender
from . import cuda_lib

launches = 0
MAX_SRC = 8          # csrc/base_ext.cu MAX_SRC
MAX_DST = 8          # csrc/base_ext.cu MAX_DST
# csrc/base_ext.cu PPQ_EXT_INSTANCES: the (ls, ld) shapes with an unrolled
# instance; any other runs the generic one
INSTANCES = tuple((ls, ld) for ls in (1, 2, 3) for ld in (1, 2, 3, 4))

_U64 = ctypes.c_uint64


class ExtParams(ctypes.Structure):
    """csrc/base_ext.cu ``ExtParams``, field for field (passed by value)."""

    _fields_ = [("q", _U64 * MAX_SRC), ("c", _U64 * MAX_SRC), ("c_sh", _U64 * MAX_SRC),
                ("recip", _U64 * MAX_SRC), ("p", _U64 * MAX_DST), ("dc", _U64 * MAX_DST),
                ("dc_sh", _U64 * MAX_DST), ("w", (_U64 * MAX_SRC) * MAX_DST),
                ("w_sh", (_U64 * MAX_SRC) * MAX_DST), ("ls", ctypes.c_int),
                ("ld", ctypes.c_int)]


def ext_params(ext: BaseExtender, pre=None) -> list:
    """[(j0, ExtParams)]: one struct per chunk of at most MAX_DST dst limbs,
    starting at dst limb j0."""
    ls = len(ext.src)
    if ls > MAX_SRC:
        raise ValueError(f"base extension kernel takes at most {MAX_SRC} src limbs, got {ls}")
    c, c_sh = ext.src_consts(pre)
    chunks = []
    for j0 in range(0, len(ext.dst), MAX_DST):
        dst = ext.dst[j0:j0 + MAX_DST]
        prm = ExtParams(ls=ls, ld=len(dst))
        for i, vals in enumerate(zip(ext.src, c, c_sh, ext.recip)):
            prm.q[i], prm.c[i], prm.c_sh[i], prm.recip[i] = vals
        for j, p in enumerate(dst):
            dc = ext.d_mod_dst[j0 + j]
            prm.p[j], prm.dc[j], prm.dc_sh[j] = p, dc, primes.shoup_precompute(dc, p)
            for i, w in enumerate(ext.dhat_mod_dst[j0 + j]):
                prm.w[j][i], prm.w_sh[j][i] = w, primes.shoup_precompute(w, p)
        chunks.append((j0, prm))
    return chunks


def base_extend(x: torch.Tensor, chunks: list, ld: int, work: int = 0) -> torch.Tensor:
    """Launch the kernel: x (Bf, ls, N) int64 → (Bf, ld, N), one launch per
    chunk of :func:`ext_params`. ``work`` 1 and 2 launch the bytes-only and
    arithmetic-only variants instead (:func:`extend_split`)."""
    global launches
    Bf, ls, n = x.shape
    if any(prm.ls != ls for _, prm in chunks) or sum(prm.ld for _, prm in chunks) != ld:
        raise ValueError(f"extend constants for other shapes than {ls} -> {ld} limbs")
    cuda_lib.require(x, "extend x")
    if n % 2 or x.data_ptr() % 16:
        raise ValueError("extend x needs an even N and 16-byte alignment")
    out = torch.empty((Bf, ld, n), dtype=torch.int64, device=x.device)
    lib = cuda_lib.library()
    with torch.cuda.device(x.device):
        for j0, prm in chunks:
            code = lib.ppq_base_extend(x.data_ptr(), out[:, j0].data_ptr(), prm, Bf, n, ld,
                                       work, cuda_lib.stream_of(x))
            if work == 0:
                launches += 1
            cuda_lib.check(code, "ppq_base_extend")
    return out


def _chunks(ext: BaseExtender, pre) -> list:
    key = ("cuda_params", None if pre is None else tuple(int(v) for v in pre))
    chunks = ext.cache.get(key)
    if chunks is None:
        chunks = ext.cache[key] = ext_params(ext, pre)
    return chunks


def fused_extend(x: torch.Tensor, ext: BaseExtender, pre=None) -> torch.Tensor:
    """x: int64[..., ls, N] → int64[..., ld, N] (coefficient domain)."""
    if not x.is_cuda:
        return ext.extend(x, pre)
    lead, (ls, n) = x.shape[:-2], x.shape[-2:]
    if ls != len(ext.src):
        raise ValueError(f"{ls} limbs given for a {len(ext.src)}-limb source basis")
    out = base_extend(x.reshape(-1, ls, n).contiguous(), _chunks(ext, pre), len(ext.dst))
    return out.reshape(lead + (len(ext.dst), n))


def extend_split(x: torch.Tensor, ext: BaseExtender, pre, work: int) -> torch.Tensor:
    """Kernel 2's time split, for measurement only (``probes/kernel_report``):
    ``work`` 1 runs the bytes-only variant (the loads and stores, no
    arithmetic), 2 the arithmetic-only one (no stores; the output is left
    unwritten). Not a launch of the path: the counter stays."""
    xb = x.reshape(-1, len(ext.src), x.shape[-1]).contiguous()
    return base_extend(xb, _chunks(ext, pre), len(ext.dst), work)
