"""Kernel 6 and the context's NTT: the four-step transform over a chain.

Twin of ``ppqsflhe_tpu.ops.pallas_ntt``'s ``FourStepNtt``: ``ntt``/``intt``
over a limb subset ``idx`` with leading batch dims, in two implementations
chosen once, by the context's ``ntt_impl`` (:func:`four_step_ntt`):

- :data:`MXU` (the JAX package's ``"pallas_mxu"``, the default, and its
  ``"xla"`` and ``"mxu"``, which give the same evaluations): the
  digit-matmul route, :class:`.cuda_mxu_ntt.CudaMxuNtt` (kernels 1, 1b, 4, 5);
- :data:`BUTTERFLY` (``"pallas"``): the constant-geometry butterfly
  transform, :class:`CudaFourStepNtt` — kernel 6 (``csrc/fourstep_ntt.cu``,
  :func:`fourstep_pass`, two launches per transform) on a CUDA tensor, the
  plain :func:`.fourstep.ntt_body_cg` / :func:`.fourstep.intt_body_cg` per
  limb on a CPU tensor.

Both leave canonical evaluations in the four-step kernel order, bit-equal,
so keys, ciphertexts and Galois permutations are shared between them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.modarith import u64_to_i64
from . import cuda_lib
from .cuda_mxu_ntt import CudaMxuNtt, _limb_subset
from .fourstep import (FourStepTables, intt_body_cg, intt_pass1, intt_pass2, kernel_to_std,
                       ntt_body_cg, ntt_pass1, ntt_pass2)
from .streamed_ntt import FUSED_NARROW, TILE, tile_width

MXU, BUTTERFLY = "pallas_mxu", "pallas"     # named by their JAX counterparts
# every four-step ntt_impl of the JAX package → the runner that gives its
# evaluations here
RUNNER = {"xla": MXU, "mxu": MXU, MXU: MXU, BUTTERFLY: BUTTERFLY}
launches = 0          # kernel 6 launches (two per transform) since the last reset
INFO = 4              # per limb and pass: q, pre-, post- and stage-table offsets
SIZES = (8, 16, 32, 64, 128, 256)   # m the kernel takes: ≤ 16 rows a thread, ≤ 98 KB of
#                                     shared memory


def fourstep_pass(x: torch.Tensor, y: torch.Tensor, tabs: torch.Tensor, info: torch.Tensor,
                  forward: bool, first: bool) -> torch.Tensor:
    """Kernel 6, one pass: x (B, L, m, c) int64 transformed down its m rows.
    ``first``: forward twist + stages + twiddle, or inverse stages + inverse
    twiddle, stored transposed into y (B, L, c, m); else the second
    transform's stages and the csub (forward) or strict itwist (inverse),
    y (B, L, m, c). ``info`` (L, 4): q and the pass's table offsets in
    ``tabs``. Raises, before any build or launch, on m outside
    :data:`SIZES`, on a partial 16-column tile (8 columns pass at m ≤ 16: the
    8-column passes of N = 2^6 and 2^7) and on a CPU tensor."""
    global launches
    B, L, m, c = x.shape
    if m not in SIZES:
        raise ValueError(f"fourstep kernel takes m in {SIZES}, got m={m}")
    tile_width(c, f"fourstep kernel at m={m}: columns", FUSED_NARROW if m <= TILE else ())
    cuda_lib.require(x, "fourstep x")
    cuda_lib.require(y, "fourstep y", (B, L, c, m) if first else (B, L, m, c))
    cuda_lib.require(tabs, "fourstep tables")
    cuda_lib.require(info, "fourstep info", (L, INFO))
    if len({t.device for t in (x, y, tabs, info)}) != 1:
        raise ValueError("fourstep tensors must share one device")
    if (x.data_ptr() | y.data_ptr()) % 16:
        raise ValueError("fourstep x and y must be 16-byte aligned")
    lib = cuda_lib.library()
    with torch.cuda.device(x.device):
        code = lib.ppq_fourstep_pass(x.data_ptr(), y.data_ptr(), tabs.data_ptr(),
                                     info.data_ptr(), B, L, m, c, int(forward), int(first),
                                     cuda_lib.stream_of(x))
    launches += 1
    cuda_lib.check(code, "ppq_fourstep_pass")
    return y


class CudaFourStepNtt:
    """The butterfly transform over a modulus chain: int64[..., L, N] with
    L = len(idx) limbs of the chain, all of them in each of kernel 6's two
    launches."""

    def __init__(self, n: int, moduli: Sequence[int], psis: Sequence[int]):
        self.n = n
        self.tabs = [FourStepTables.build(n, int(q), int(p)) for q, p in zip(moduli, psis)]
        self.n1, self.n2 = self.tabs[0].n1, self.tabs[0].n2
        self.perm_to_std = kernel_to_std(n)          # std[b] = kernel[perm[b]]
        self._dev: dict = {}

    def ntt(self, x: torch.Tensor, idx=None) -> torch.Tensor:
        """coeff (natural order) → eval (kernel order)."""
        return self._run(x, True, idx)

    def intt(self, x: torch.Tensor, idx=None) -> torch.Tensor:
        return self._run(x, False, idx)

    def plain(self, x: torch.Tensor, forward: bool, sel) -> torch.Tensor:
        """The plain transform of limbs ``sel`` of the chain, on any device."""
        lead = x.shape[:-2]
        shape = (self.n1, self.n2) if forward else (self.n2, self.n1)
        fn = ntt_body_cg if forward else intt_body_cg
        return torch.stack([fn(x[..., k, :].reshape(lead + shape), self.tabs[i])
                            .reshape(lead + (self.n,)) for k, i in enumerate(sel)], dim=-2)

    def plain_pass(self, x: torch.Tensor, forward: bool, first: bool, sel) -> torch.Tensor:
        """The plain version of one kernel-6 launch over limbs ``sel``: x
        (B, L, m, c) → (B, L, c, m) for the first pass, (B, L, m, c) for the
        second."""
        fn = {(True, True): ntt_pass1, (True, False): ntt_pass2,
              (False, True): intt_pass1, (False, False): intt_pass2}[forward, first]
        return torch.stack([fn(x[:, k], self.tabs[i]) for k, i in enumerate(sel)], dim=1)

    def _run(self, x, forward, idx):
        sel = _limb_subset(x, len(self.tabs), idx, self.n)
        if not x.is_cuda:
            return self.plain(x, forward, sel)
        lead, L = x.shape[:-2], len(sel)
        m1, m2 = (self.n1, self.n2) if forward else (self.n2, self.n1)
        xb = x.reshape(-1, L, m1, m2).contiguous()
        tabs, info1, info2 = self.device(x.device, sel, forward)
        t = torch.empty((xb.shape[0], L, m2, m1), dtype=torch.int64, device=x.device)
        fourstep_pass(xb, t, tabs, info1, forward, first=True)
        y = torch.empty_like(t)
        fourstep_pass(t, y, tabs, info2, forward, first=False)
        return y.reshape(lead + (L, self.n))

    def device(self, device, sel, forward):
        """(tables, first-pass info, second-pass info) on ``device``. Each
        limb's tables are one block of (value, companion) pairs per
        direction — forward: twist, twiddle, pgs1, pgs2; inverse: the inverse
        twiddle transposed to (n2, n1), itwist, pct2, pct1 — uploaded once
        per device; the info rows once per limb subset and direction."""
        key = str(device)
        d = self._dev.get(key)
        if d is None:
            parts, offs, off = [], [], 0
            for t in self.tabs:
                o = {}
                itw_t = tuple(np.ascontiguousarray(a.T) for a in t.itwiddle)
                for name, pair in (("twist", t.twist), ("twiddle", t.twiddle),
                                   ("pgs1", t.pgs1), ("pgs2", t.pgs2), ("itwiddle_t", itw_t),
                                   ("itwist", t.itwist), ("pct2", t.pct2), ("pct1", t.pct1)):
                    o[name] = off
                    parts += [a.reshape(-1) for a in pair]
                    off += 2 * pair[0].size
                offs.append(o)
            d = self._dev[key] = dict(
                tabs=torch.as_tensor(np.concatenate(parts).view(np.int64), device=device),
                offs=offs, info={})
        ikey = (tuple(sel), forward)
        if ikey not in d["info"]:
            names = ((("twist", "twiddle", "pgs1"), (None, None, "pgs2")) if forward else
                     ((None, "itwiddle_t", "pct2"), (None, "itwist", "pct1")))
            d["info"][ikey] = tuple(
                torch.as_tensor(u64_to_i64([[self.tabs[i].q] + [d["offs"][i][nm] if nm else 0
                                                                for nm in pass_names]
                                            for i in sel]), device=device)
                for pass_names in names)
        return (d["tabs"],) + d["info"][ikey]


def four_step_ntt(n: int, moduli: Sequence[int], psis: Sequence[int], impl: str = MXU):
    """The context's NTT runner over a modulus chain, by ``impl``:
    :data:`MXU` → :class:`.cuda_mxu_ntt.CudaMxuNtt`, :data:`BUTTERFLY` →
    :class:`CudaFourStepNtt`. Either has ``ntt``/``intt`` over a limb subset
    and ``perm_to_std``; its tables are built here, once."""
    if impl not in (MXU, BUTTERFLY):
        raise ValueError(f"ntt_impl={impl!r}: the port has {MXU!r} and {BUTTERFLY!r}")
    return (CudaMxuNtt if impl == MXU else CudaFourStepNtt)(n, moduli, psis)
