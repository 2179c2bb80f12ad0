"""Kernel 1: the digit-matmul NTT on the card, and its runner over a chain.

Twin of ``ppqsflhe_tpu.ops.pallas_mxu_ntt.PallasMxuNtt`` (``ntt``/``intt``
over a limb subset ``idx``) folded together with the ``FourStepNtt``
dispatch: a CPU tensor goes through the plain torch transform
(:func:`.mxu_ntt.mxu_ntt_limb`, one limb at a time), a CUDA tensor through
the hand-written kernel ``csrc/mxu_ntt.cu`` — two launches per transform,
one per column stage, covering every limb and every batch entry. Limbs of
different digit counts (60-bit nd=9, 40-bit nd=6) share a launch: each limb
carries its own nd in the launch's info table. Outputs are canonical
residues in the four-step kernel order, bit-equal either way.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import cuda_lib
from .mxu_ntt import MxuNttTables, mxu_intt_limb, mxu_ntt_limb

launches = 0          # kernel launches (two per transform) since the last reset
INFO = 5              # per limb: matrix offset, nd, q, qinv_r, twiddle offset
SPLIT = 4             # the kernel's REDC recompose by 2^28
MAX_ND = 9            # csrc/mxu_ntt.cu MAX_ND


def ntt_stage(x: torch.Tensor, y: torch.Tensor, mats: torch.Tensor,
              info: torch.Tensor, tw: torch.Tensor, twiddle: bool) -> torch.Tensor:
    """Launch one column stage. x: (B, L, m, c) int64, contracted over m;
    y: (B, L, c, m) with ``twiddle`` (stage 1: lazy Shoup twiddle, store
    transposed) else (B, L, m, c) (stage 2: canonical residues)."""
    global launches
    B, L, m, c = x.shape
    cuda_lib.require(x, "ntt x")
    cuda_lib.require(y, "ntt y", (B, L, c, m) if twiddle else (B, L, m, c))
    cuda_lib.require(info, "ntt info", (L, INFO))
    cuda_lib.require(tw, "ntt twiddles")
    if mats.dtype != torch.int8 or not mats.is_contiguous():
        raise ValueError("ntt matrices must be a contiguous int8 tensor")
    if len({t.device for t in (x, y, mats, info, tw)}) != 1:
        raise ValueError("ntt tensors must share one device")
    if m % 32:
        raise ValueError(f"ntt kernel needs m % 32 == 0, got m={m}")
    lib = cuda_lib.library()
    with torch.cuda.device(x.device):
        code = lib.ppq_mxu_ntt_stage(
            x.data_ptr(), y.data_ptr(), mats.data_ptr(), info.data_ptr(),
            tw.data_ptr(), B, L, m, c, int(twiddle), cuda_lib.stream_of(x))
    launches += 1
    cuda_lib.check(code, "ppq_mxu_ntt_stage")
    return y


class CudaMxuNtt:
    """Forward/inverse transforms over a modulus chain: int64[..., L, N]
    with L = len(idx) limbs of the chain."""

    _MATS = ("a1", "a2", "a2i", "a1i")

    def __init__(self, n: int, moduli: Sequence[int], psis: Sequence[int]):
        self.n = n
        self.moduli = tuple(int(q) for q in moduli)
        self.tabs = [MxuNttTables.build(n, q, int(p)) for q, p in zip(self.moduli, psis)]
        self.n1, self.n2 = self.tabs[0].n1, self.tabs[0].n2
        self._dev: dict = {}

    def ntt(self, x: torch.Tensor, idx=None) -> torch.Tensor:
        """coeff (natural order) → eval (kernel order)."""
        return self._run(x, True, idx)

    def intt(self, x: torch.Tensor, idx=None) -> torch.Tensor:
        return self._run(x, False, idx)

    def _run(self, x, forward, idx):
        sel = list(range(len(self.tabs))) if idx is None else [int(i) for i in idx]
        if x.shape[-2] != len(sel):
            raise ValueError(f"{x.shape[-2]} limbs given for limb subset {sel}")
        if not x.is_cuda:
            fn = mxu_ntt_limb if forward else mxu_intt_limb
            return torch.stack([fn(x[..., k, :], self.tabs[i]) for k, i in enumerate(sel)],
                               dim=-2)
        lead, L = x.shape[:-2], len(sel)
        xb = x.reshape(-1, L, self.n).contiguous()
        B = xb.shape[0]
        mats, tw, info1, info2 = self._device_tables(x.device, tuple(sel), forward)
        m1, m2 = (self.n1, self.n2) if forward else (self.n2, self.n1)
        y = torch.empty((B, L, m2, m1), dtype=torch.int64, device=x.device)
        ntt_stage(xb.view(B, L, m1, m2), y, mats, info1, tw, twiddle=True)
        z = torch.empty_like(y)
        ntt_stage(y, z, mats, info2, tw, twiddle=False)
        return z.reshape(lead + (L, self.n))

    def _device_tables(self, device, sel, forward):
        """(matrices, twiddles, stage-1 info, stage-2 info) on ``device``;
        the chain's tables upload once per device, the info rows once per
        limb subset and direction."""
        key = str(device)
        d = self._dev.get(key)
        if d is None:
            for t in self.tabs:
                if t.plan.split != SPLIT or t.nd > MAX_ND:
                    raise ValueError(f"CUDA NTT needs the split={SPLIT} REDC plan and at "
                                     f"most {MAX_ND} digits (q={t.q})")
            mats, mat_off, off = [], [], 0
            for t in self.tabs:
                offs = {}
                for name in self._MATS:
                    a = t.stage_matrix(name).reshape(-1)
                    offs[name] = off
                    mats.append(a)
                    off += a.size
                mat_off.append(offs)
            tws, tw_off, off = [], [], 0
            for t in self.tabs:
                offs = {}
                for fwd, (w, ws) in ((True, t.t1), (False, t.t1i)):
                    offs[fwd] = off
                    tws += [w.reshape(-1), ws.reshape(-1)]
                    off += 2 * w.size
                tw_off.append(offs)
            d = self._dev[key] = dict(
                mats=torch.as_tensor(np.concatenate(mats), device=device),
                tw=torch.as_tensor(np.concatenate(tws).view(np.int64), device=device),
                mat_off=mat_off, tw_off=tw_off, info={})
        ikey = (sel, forward)
        if ikey not in d["info"]:
            first, second = ("a1", "a2") if forward else ("a2i", "a1i")
            rows = lambda name, with_tw: [
                [d["mat_off"][i][name], self.tabs[i].nd, self.tabs[i].q,
                 self.tabs[i].plan.qinv_r, d["tw_off"][i][forward] if with_tw else 0]
                for i in sel]
            d["info"][ikey] = tuple(
                torch.as_tensor(np.array(rows(name, tw), np.int64), device=device)
                for name, tw in ((first, True), (second, False)))
        return (d["mats"], d["tw"]) + d["info"][ikey]
