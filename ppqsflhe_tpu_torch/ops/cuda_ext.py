"""Kernel 2: the HPS fast base extension on the card.

Twin of :func:`ppqsflhe_tpu.ops.pallas_ext.fused_extend`: a drop-in for
``extender.extend(x)`` in the coefficient domain, optionally with per-src
constants ``pre`` folded into the first multiply (the key-switch digit
decomposition's [Q̂_j^{-1}]_{q_i}). A CPU tensor runs the plain
:meth:`..core.rns.BaseExtender.extend`; a CUDA tensor launches
``csrc/base_ext.cu``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import primes
from ..core.rns import BaseExtender
from . import cuda_lib

launches = 0
MAX_SRC = 8          # csrc/base_ext.cu MAX_SRC


def _const_table(ext: BaseExtender, pre) -> np.ndarray:
    """The kernel's constant layout (see csrc/base_ext.cu) as int64 bits."""
    c, c_sh = ext.src_consts(pre)
    vals = []
    for q, ci, si, r in zip(ext.src, c, c_sh, ext.recip):
        vals += [q, ci, si, r]
    for p, dc in zip(ext.dst, ext.d_mod_dst):
        vals += [p, dc, primes.shoup_precompute(dc, p)]
    for j, p in enumerate(ext.dst):
        for w in ext.dhat_mod_dst[j]:
            vals += [w, primes.shoup_precompute(w, p)]
    return np.array(vals, np.uint64).view(np.int64)


def base_extend(x: torch.Tensor, consts: torch.Tensor, ld: int) -> torch.Tensor:
    """Launch the kernel: x (Bf, ls, N) int64 → (Bf, ld, N)."""
    global launches
    Bf, ls, n = x.shape
    cuda_lib.require(x, "extend x")
    cuda_lib.require(consts, "extend consts", (4 * ls + 3 * ld + 2 * ld * ls,))
    if ls > MAX_SRC:
        raise ValueError(f"base extension kernel takes at most {MAX_SRC} src limbs")
    out = torch.empty((Bf, ld, n), dtype=torch.int64, device=x.device)
    lib = cuda_lib.library()
    with torch.cuda.device(x.device):
        code = lib.ppq_base_extend(x.data_ptr(), out.data_ptr(), consts.data_ptr(),
                                   Bf, ls, ld, n, cuda_lib.stream_of(x))
    launches += 1
    cuda_lib.check(code, "ppq_base_extend")
    return out


def fused_extend(x: torch.Tensor, ext: BaseExtender, pre=None) -> torch.Tensor:
    """x: int64[..., ls, N] → int64[..., ld, N] (coefficient domain)."""
    if not x.is_cuda:
        return ext.extend(x, pre)
    lead, (ls, n) = x.shape[:-2], x.shape[-2:]
    if ls != len(ext.src):
        raise ValueError(f"{ls} limbs given for a {len(ext.src)}-limb source basis")
    key = ("cuda_consts", str(x.device), None if pre is None else tuple(int(v) for v in pre))
    consts = ext.cache.get(key)
    if consts is None:
        consts = ext.cache[key] = torch.as_tensor(_const_table(ext, pre), device=x.device)
    out = base_extend(x.reshape(-1, ls, n).contiguous(), consts, len(ext.dst))
    return out.reshape(lead + (len(ext.dst), n))
