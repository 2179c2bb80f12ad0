"""Kernel 3: the hybrid key-switch KSK inner product on the card.

Twin of :func:`ppqsflhe_tpu.ops.pallas_ks.ks_inner_product`:

    acc_c = Σ_j mont_mul(digit_j, ksk[j, c])   (c = 0, 1; mod q per limb)

over the extended basis Q_l ∪ P, with the key in Montgomery form and shared
across the batch. A CPU tensor runs :func:`ks_inner_product_plain`; a CUDA
tensor launches ``csrc/ks_ip.cu``, which reads the needed limbs straight out
of the full key through a limb map. The limb map and the per-limb q and
-q^{-1} columns come from the caller (``CkksContext`` caches them per device).
"""

from __future__ import annotations

import torch

from ..core.modarith import modadd, mont_mul
from . import cuda_lib

launches = 0


def ks_inner_product_plain(digits, ksk, sel, q, qinv):
    """digits: int64[..., nd, LK, N]; ksk: int64[ndk ≥ nd, 2, LKT, N]
    (Montgomery form); sel: int64 (LK,) or (LK, 1), the key's LKT-axis index
    of each of the LK limbs; q, qinv: int64 (LK, 1), each limb's modulus and
    -q^{-1} mod 2^64. → int64[..., 2, LK, N]."""
    sel = sel.reshape(-1)
    acc = None
    for j in range(digits.shape[-3]):
        t = mont_mul(digits[..., j : j + 1, :, :], ksk[j].index_select(1, sel), q, qinv)
        acc = t if acc is None else modadd(acc, t, q)
    return acc


def ks_inner_product(digits: torch.Tensor, ksk: torch.Tensor, sel: torch.Tensor,
                     q: torch.Tensor, qinv: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`ks_inner_product_plain`; launches the kernel
    for CUDA tensors."""
    global launches
    if not digits.is_cuda:
        return ks_inner_product_plain(digits, ksk, sel, q, qinv)
    lead, (nd, LK, n) = digits.shape[:-3], digits.shape[-3:]
    cuda_lib.require(ksk, "ks key")
    for name, t in (("limb map", sel), ("q", q), ("qinv", qinv)):
        cuda_lib.require(t, f"ks {name}")
        if t.numel() != LK or t.device != digits.device:
            raise ValueError(f"ks inner product: {name} {tuple(t.shape)} on {t.device} "
                             f"for {LK} limbs on {digits.device}")
    if (ksk.dim() != 4 or ksk.shape[0] < nd or ksk.shape[1] != 2 or ksk.shape[-1] != n
            or ksk.device != digits.device):
        raise ValueError(f"ks inner product: digits {tuple(digits.shape)} vs key "
                         f"{tuple(ksk.shape)} on {ksk.device}")
    dig = digits.reshape(-1, nd, LK, n).contiguous()
    Bf, LKT = dig.shape[0], ksk.shape[2]
    out = torch.empty((Bf, 2, LK, n), dtype=torch.int64, device=digits.device)
    lib = cuda_lib.library()
    with torch.cuda.device(digits.device):
        code = lib.ppq_ks_inner_product(dig.data_ptr(), ksk.data_ptr(), out.data_ptr(),
                                        sel.data_ptr(), q.data_ptr(), qinv.data_ptr(), Bf,
                                        nd, LK, LKT, n, cuda_lib.stream_of(dig))
    launches += 1
    cuda_lib.check(code, "ppq_ks_inner_product")
    return out.reshape(lead + (2, LK, n))
