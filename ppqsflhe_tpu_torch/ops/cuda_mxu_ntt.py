"""Kernels 1 and 1b (the fused NTT route) on the card, and the runners.

Twins of ``ppqsflhe_tpu.ops.pallas_mxu_ntt``: :class:`CudaMxuNtt` is
``PallasMxuNtt`` (``ntt``/``intt`` over a limb subset ``idx``) folded
together with the ``FourStepNtt`` dispatch, and :class:`CudaMxuNttBig` is
``PallasMxuNttBig``, the streamed two-pass variant. The TPU ran every stage
as an int8 digit-matrix product; on this card all four kernels run the
factors of those matrices as 64-bit Shoup butterflies
(``csrc/butterfly.cuh``), over the tables of :class:`.streamed_ntt.StreamedChain`:

- kernel 1 (:func:`ntt_stage`, two launches per transform, in
  ``csrc/mxu_ntt.cu``): the fused route, the first stage storing transposed,
  the second in place; plain versions :func:`stage1_plain`,
  :func:`stage2_plain`;
- kernel 1b (:func:`ntt_stage` with ``mont=True``): the same with the
  Montgomery twiddle, the route of a group whose Shoup tables did not fit
  the TPU kernel's VMEM but whose Montgomery ones did;
- kernels 4 and 5 (:func:`.streamed_ntt.stage_a`, :func:`.streamed_ntt.stage_b`,
  in ``csrc/streamed_ntt.cu``): the streamed pair, stage A storing
  untransposed and stage B transforming along the last axis.

:func:`route` reproduces the JAX runner's choice per digit-count group, so
each limb runs through the kernels that its TPU counterpart ran. A CPU
tensor goes through the plain torch versions, a CUDA tensor through the
kernels; outputs are canonical residues in the four-step kernel order,
bit-equal either way and to the digit-matmul plain transforms
(:func:`.mxu_ntt.mxu_ntt_limb`).
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch

from ..utils import profiling
from . import cuda_lib
from .fourstep import kernel_to_std
from .mxu_ntt import MxuNttTables
from .streamed_ntt import (FUSED_NARROW, INFO, TILE, StreamedChain, first_stage, second_stage,
                           stage_a, stage_a_plain, stage_b, stage_b_plain, tile_width)

launches = 0          # kernel 1 launches (two per transform) since the last reset
launches_mont = 0     # kernel 1b launches (two per transform)
SIZES = (8, 16, 32, 64, 128, 256)   # the m kernels 1 and 1b take: N = 2^6 ... 2^16
# the JAX runner's default scoped-VMEM budget for one fused grid cell
# (PallasMxuNtt._vmem_budget with PPQSFLHE_FUSED_VMEM_KIB unset)
FUSED_VMEM_BUDGET = 1024 * 12896
ROUTE_SPANS = {"big": "ntt.big", "fused_mont": "ntt.mont"}   # spans of a mixed transform


def route(n: int, nd: int) -> str:
    """The JAX runner's decision for a group of nd-digit limbs at ring size
    n (``PallasMxuNtt._run`` with ``_group_fits`` at its default budget):
    "fused" (kernel 1) when the cell fits with the 4-plane Shoup twiddle,
    "fused_mont" (kernel 1b) when it fits only with the 2-plane Montgomery
    one, else "big" (kernels 4 and 5)."""
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    mats = (nd * n1) ** 2 + (nd * n2) ** 2
    xbuf = 4 * n * 4
    fits = lambda planes: 2 * (mats + planes * n * 4 + xbuf) <= FUSED_VMEM_BUDGET
    return "fused" if fits(4) else "fused_mont" if fits(2) else "big"


def stage1_plain(x: torch.Tensor, tabs, forward: bool, mont: bool = False) -> torch.Tensor:
    """Kernel 1's first stage (kernel 1b's with ``mont``): x (B, L, m, c)
    int64, values < 4q, transformed down its m rows → (B, L, c, m), values
    < 2q, stored transposed. ``tabs``: the L limbs'
    :class:`.streamed_ntt.StreamedTables`."""
    return torch.stack([first_stage(x[:, l], t, forward, mont=mont).transpose(-1, -2)
                        for l, t in enumerate(tabs)], dim=1)


def stage2_plain(y: torch.Tensor, tabs, forward: bool) -> torch.Tensor:
    """The second stage of kernels 1 and 1b: y (B, L, m, c), values < 2q,
    transformed down its m rows → (B, L, m, c) canonical residues."""
    return torch.stack([second_stage(y[:, l], t, forward) for l, t in enumerate(tabs)], dim=1)


def ntt_stage(x: torch.Tensor, y: torch.Tensor, tabs: torch.Tensor, info: torch.Tensor,
              forward: bool, first: bool, mont: bool = False) -> torch.Tensor:
    """Kernel 1 (kernel 1b with ``mont``), one column stage: x (B, L, m, c)
    int64 transformed down its m rows. ``first``: stage 1, twiddled (lazy
    Shoup, or with ``mont`` lazy Montgomery against the w·2^64 mod q table)
    and stored transposed to y (B, L, c, m), values < 2q; else stage 2, y
    (B, L, m, c), canonical residues. ``info`` (L, 4): q and the stage's
    table offsets in ``tabs`` (:meth:`.streamed_ntt.StreamedChain.device`).
    m is in :data:`SIZES` and c whole 16-column tiles, or 8 (the 8-column
    stages of N = 2^6 and 2^7, m ≤ 16); raises ValueError otherwise, before
    any build or launch."""
    global launches, launches_mont
    B, L, m, c = x.shape
    if m not in SIZES:
        raise ValueError(f"ntt kernel takes m in {SIZES}, got m={m}")
    tile_width(c, f"ntt kernel at m={m}: columns", FUSED_NARROW if m <= TILE else ())
    cuda_lib.require(x, "ntt x")
    cuda_lib.require(y, "ntt y", (B, L, c, m) if first else (B, L, m, c))
    cuda_lib.require(tabs, "ntt tables")
    cuda_lib.require(info, "ntt info", (L, INFO))
    if len({t.device for t in (x, y, tabs, info)}) != 1:
        raise ValueError("ntt tensors must share one device")
    if (x.data_ptr() | y.data_ptr()) % 16:
        raise ValueError("ntt x and y must be 16-byte aligned")
    lib = cuda_lib.library()
    name = "ppq_mxu_ntt_stage_mont" if mont else "ppq_mxu_ntt_stage"
    with torch.cuda.device(x.device):
        code = getattr(lib, name)(
            x.data_ptr(), y.data_ptr(), tabs.data_ptr(), info.data_ptr(), B, L, m, c,
            int(forward), int(first), cuda_lib.stream_of(x))
    if mont:
        launches_mont += 1
    else:
        launches += 1
    cuda_lib.check(code, name)
    return y


class MxuChainTables:
    """A chain's per-limb tables: each limb's
    :class:`.mxu_ntt.MxuNttTables` (whose digit matrices are built only when
    a digit plain version asks for them; no kernel reads one) and the
    butterfly tables of kernels 1, 1b, 4 and 5
    (:class:`.streamed_ntt.StreamedChain`), uploaded per device for the
    limbs asked for."""

    def __init__(self, n: int, moduli: Sequence[int], psis: Sequence[int]):
        self.n = n
        self.tabs = [MxuNttTables.build(n, int(q), int(p)) for q, p in zip(moduli, psis)]
        self.n1, self.n2 = self.tabs[0].n1, self.tabs[0].n2
        self.streamed = StreamedChain(self.tabs)
        self._pos: dict = {}

    def positions(self, ks, device) -> torch.Tensor:
        """Limb positions ``ks`` as a long tensor on ``device``, cached: a
        fresh upload per call would make the host wait for the stream."""
        key = (tuple(ks), str(device))
        if key not in self._pos:
            self._pos[key] = torch.tensor(ks, device=device)
        return self._pos[key]


def _limb_subset(x, nlimbs, idx, n):
    sel = list(range(nlimbs)) if idx is None else [int(i) for i in idx]
    if x.shape[-2] != len(sel) or x.shape[-1] != n:
        raise ValueError(f"{tuple(x.shape[-2:])} limbs x coefficients given for limb "
                         f"subset {sel} at N={n}")
    return sel


def _by_group(tables, x, sel, key, run):
    """Split the limbs ``sel`` of x (limb axis -2) by ``key(limb)``, call
    ``run(part, limbs, key)`` on each group, and put the results back in
    the input's limb order."""
    groups: dict = {}
    for k, i in enumerate(sel):
        groups.setdefault(key(i), []).append(k)
    if len(groups) == 1:
        return run(x, sel, next(iter(groups)))
    out = torch.empty_like(x)
    for g, ks in groups.items():
        pos = tables.positions(ks, x.device)
        out.index_copy_(-2, pos, run(x.index_select(-2, pos), [sel[k] for k in ks], g))
    return out


class CudaMxuNttBig:
    """The streamed pair over a chain: per digit-count group, stage A
    (kernel 4) then stage B (kernel 5), with no transpose between them, both
    Shoup butterflies (:mod:`.streamed_ntt`). int64[..., L, N] with
    L = len(idx) limbs of the chain."""

    def __init__(self, tables: MxuChainTables):
        self.tables = tables
        self.n, self.n1, self.n2 = tables.n, tables.n1, tables.n2
        self.streamed = tables.streamed

    def ntt(self, x: torch.Tensor, idx=None) -> torch.Tensor:
        return self._run(x, True, idx)

    def intt(self, x: torch.Tensor, idx=None) -> torch.Tensor:
        return self._run(x, False, idx)

    def _run(self, x, forward, idx):
        tabs = self.tables.tabs
        sel = _limb_subset(x, len(tabs), idx, self.n)
        return _by_group(self.tables, x, sel, lambda i: tabs[i].nd,
                         lambda part, sub, nd: self._group(part, forward, sub))

    def _group(self, x, forward, sel):
        lead, L = x.shape[:-2], len(sel)
        m1, m2 = (self.n1, self.n2) if forward else (self.n2, self.n1)
        xb = x.reshape(-1, L, m1, m2)
        if not x.is_cuda:
            tabs = [self.streamed.limb(i) for i in sel]
            z = stage_b_plain(stage_a_plain(xb, tabs, forward), tabs, forward)
            return z.reshape(lead + (L, self.n))
        xb = xb.contiguous()
        tabs, info_a, info_b = self.streamed.device(x.device, sel, forward)
        y = stage_a(xb, torch.empty_like(xb), tabs, info_a, forward, m2)
        z = torch.empty((xb.shape[0], L, m2, m1), dtype=torch.int64, device=x.device)
        stage_b(y, z, tabs, info_b, forward)
        return z.reshape(lead + (L, self.n))


class CudaMxuNtt:
    """Forward/inverse transforms over a modulus chain: int64[..., L, N]
    with L = len(idx) limbs of the chain. Limbs whose digit-count group
    routes "fused" run kernel 1 together (two launches for all of them),
    "fused_mont" kernel 1b; "big" groups run through :class:`CudaMxuNttBig`."""

    def __init__(self, n: int, moduli: Sequence[int], psis: Sequence[int]):
        self.tables = MxuChainTables(n, moduli, psis)
        self.n, self.tabs = n, self.tables.tabs
        self.n1, self.n2 = self.tables.n1, self.tables.n2
        self.big = CudaMxuNttBig(self.tables)
        self.perm_to_std = kernel_to_std(n)          # std[b] = kernel[perm[b]]

    def ntt(self, x: torch.Tensor, idx=None) -> torch.Tensor:
        """coeff (natural order) → eval (kernel order)."""
        return self._run(x, True, idx)

    def intt(self, x: torch.Tensor, idx=None) -> torch.Tensor:
        return self._run(x, False, idx)

    def _run(self, x, forward, idx):
        sel = _limb_subset(x, len(self.tabs), idx, self.n)
        key = lambda i: route(self.n, self.tabs[i].nd)
        mixed = len({key(i) for i in sel}) > 1
        return _by_group(self.tables, x, sel, key,
                         lambda part, sub, r: self._route(part, forward, sub, r, mixed))

    def _route(self, x, forward, sel, r, mixed):
        """Limbs ``sel`` of one route. Where one transform's limbs take more
        than one route, the big and Montgomery groups run inside the spans
        ``ntt.big`` and ``ntt.mont``."""
        name = ROUTE_SPANS.get(r) if mixed else None
        with profiling.span(name) if name else contextlib.nullcontext():
            if r == "big":
                return self.big._run(x, forward, sel)
            return self.fused(x, forward, sel, r == "fused_mont")

    def fused(self, x: torch.Tensor, forward: bool, sel, mont: bool = False) -> torch.Tensor:
        """The fused route over limbs ``sel`` of the chain, whatever
        :func:`route` says: kernel 1 (kernel 1b with ``mont``) on the card,
        :meth:`fused_plain` on the CPU."""
        if not x.is_cuda:
            return self.fused_plain(x, forward, sel, mont)
        lead, L = x.shape[:-2], len(sel)
        m1, m2 = (self.n1, self.n2) if forward else (self.n2, self.n1)
        xb = x.reshape(-1, L, m1, m2).contiguous()
        tabs, info1, info2 = self.tables.streamed.device(x.device, sel, forward, mont)
        y = torch.empty((xb.shape[0], L, m2, m1), dtype=torch.int64, device=x.device)
        ntt_stage(xb, y, tabs, info1, forward, first=True, mont=mont)
        z = torch.empty_like(y)
        ntt_stage(y, z, tabs, info2, forward, first=False, mont=mont)
        return z.reshape(lead + (L, self.n))

    def fused_plain(self, x: torch.Tensor, forward: bool, sel, mont: bool = False):
        """The plain versions of kernel 1's (1b's) two stages over limbs
        ``sel`` of the chain, on any device."""
        lead, L = x.shape[:-2], len(sel)
        m1, m2 = (self.n1, self.n2) if forward else (self.n2, self.n1)
        tabs = [self.tables.streamed.limb(i) for i in sel]
        y = stage1_plain(x.reshape(-1, L, m1, m2), tabs, forward, mont)
        return stage2_plain(y, tabs, forward).reshape(lead + (L, self.n))
