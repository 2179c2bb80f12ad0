"""Kernels 1 and 1b (the digit-matmul NTT) on the card, and the runners.

Twins of ``ppqsflhe_tpu.ops.pallas_mxu_ntt``: :class:`CudaMxuNtt` is
``PallasMxuNtt`` (``ntt``/``intt`` over a limb subset ``idx``) folded
together with the ``FourStepNtt`` dispatch, and :class:`CudaMxuNttBig` is
``PallasMxuNttBig``, the streamed two-pass variant:

- kernel 1 (:func:`ntt_stage`, two launches per transform, in
  ``csrc/mxu_ntt.cu``): the fused route, the first stage storing transposed;
- kernel 1b (:func:`ntt_stage` with ``mont=True``): the same with the
  Montgomery twiddle, the route of a group whose Shoup tables did not fit
  the TPU kernel's VMEM but whose Montgomery ones did;
- kernels 4 and 5 (:func:`.streamed_ntt.stage_a`, :func:`.streamed_ntt.stage_b`,
  in ``csrc/streamed_ntt.cu``): the streamed pair, as Shoup butterflies,
  stage A storing untransposed and stage B transforming along the last axis.

:func:`route` reproduces the JAX runner's choice per digit-count group, so
each limb runs through the kernels that its TPU counterpart ran. A CPU
tensor goes through the plain torch versions (:mod:`.mxu_ntt`), a CUDA
tensor through the kernels; outputs are canonical residues in the four-step
kernel order, bit-equal either way.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.modarith import u64_to_i64
from . import cuda_lib
from .fourstep import kernel_to_std
from .mxu_ntt import MxuNttTables, mxu_intt_limb, mxu_ntt_limb
from .streamed_ntt import StreamedChain, stage_a, stage_a_plain, stage_b, stage_b_plain

launches = 0          # kernel 1 launches (two per transform) since the last reset
launches_mont = 0     # kernel 1b launches (two per transform)
INFO = 6              # per limb: matrix offset, nd, q, qinv_r, twiddle offset, qinv64
SPLIT = 4             # the kernel's REDC recompose by 2^28
MAX_ND = 9            # csrc/mxu_ntt.cu MAX_ND
# the JAX runner's default scoped-VMEM budget for one fused grid cell
# (PallasMxuNtt._vmem_budget with PPQSFLHE_FUSED_VMEM_KIB unset)
FUSED_VMEM_BUDGET = 1024 * 12896


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


def _check_stage(name, x, y, y_shape, mats, info, tw, m):
    cuda_lib.require(x, f"{name} x")
    cuda_lib.require(y, f"{name} y", y_shape)
    cuda_lib.require(info, f"{name} info", (x.shape[1], INFO))
    cuda_lib.require(tw, f"{name} twiddles")
    tensors = [x, y, mats, info, tw]
    if mats.dtype != torch.int8 or not mats.is_contiguous():
        raise ValueError(f"{name} matrices must be a contiguous int8 tensor")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name} tensors must share one device")
    if m % 32:
        raise ValueError(f"{name} kernel needs m % 32 == 0, got m={m}")
    if MAX_ND * m * 127 * 127 >= 1 << 31:
        raise ValueError(f"{name}: {MAX_ND} digits x m={m} overflow the int32 planes")


def ntt_stage(x: torch.Tensor, y: torch.Tensor, mats: torch.Tensor, info: torch.Tensor,
              tw: torch.Tensor, twiddle: bool, mont: bool = False) -> torch.Tensor:
    """Kernel 1 (kernel 1b with ``mont``), one column stage. x: (B, L, m, c)
    int64, contracted over m; y: (B, L, c, m) with ``twiddle`` (stage 1:
    lazy Shoup twiddle, or Montgomery against w·2^64 mod q tables with
    ``mont``; store transposed) else (B, L, m, c) (stage 2: canonical
    residues)."""
    global launches, launches_mont
    B, L, m, c = x.shape
    _check_stage("ntt", x, y, (B, L, c, m) if twiddle else (B, L, m, c), mats, info, tw, m)
    lib = cuda_lib.library()
    name = "ppq_mxu_ntt_stage_mont" if mont else "ppq_mxu_ntt_stage"
    with torch.cuda.device(x.device):
        code = getattr(lib, name)(
            x.data_ptr(), y.data_ptr(), mats.data_ptr(), info.data_ptr(),
            tw.data_ptr(), B, L, m, c, int(twiddle), cuda_lib.stream_of(x))
    if mont:
        launches_mont += 1
    else:
        launches += 1
    cuda_lib.check(code, name)
    return y


class MxuChainTables:
    """A chain's per-limb tables and their upload to each device for the
    fused route: the four stage matrices of each limb in one int8 buffer,
    its twiddles in one int64 buffer (per direction the Shoup pair, w then
    w_shoup, and the Montgomery table w·2^64 mod q, each row-major), and the
    kernels' info rows per (limb subset, direction, twiddle kind). Only the
    limbs the fused route has asked for are uploaded: a call naming a new
    limb builds its matrices and re-uploads the union (so the offsets in the
    info rows change), and a limb that only runs the streamed pair carries
    none."""

    _MATS = ("a1", "a2", "a2i", "a1i")

    def __init__(self, n: int, moduli: Sequence[int], psis: Sequence[int]):
        self.n = n
        self.tabs = [MxuNttTables.build(n, int(q), int(p)) for q, p in zip(moduli, psis)]
        self.n1, self.n2 = self.tabs[0].n1, self.tabs[0].n2
        self._dev: dict = {}
        self._pos: dict = {}

    def positions(self, ks, device) -> torch.Tensor:
        """Limb positions ``ks`` as a long tensor on ``device``, cached: a
        fresh upload per call would make the host wait for the stream."""
        key = (tuple(ks), str(device))
        if key not in self._pos:
            self._pos[key] = torch.tensor(ks, device=device)
        return self._pos[key]

    def device(self, device, sel, forward, mont=False):
        """(matrices, twiddles, first-stage info, second-stage info) on
        ``device`` for limbs ``sel``; the info rows are cached per limb
        subset, direction and twiddle kind (``mont``: the first stage's
        twiddle offset points at the Montgomery table)."""
        key = str(device)
        d = self._dev.get(key)
        if d is None or not set(sel) <= d["limbs"]:
            limbs = sorted(set(sel) | (d["limbs"] if d else set()))
            for i in limbs:
                t = self.tabs[i]
                if t.plan.split != SPLIT or t.nd > MAX_ND:
                    raise ValueError(f"CUDA NTT needs the split={SPLIT} REDC plan and at "
                                     f"most {MAX_ND} digits (q={t.q})")
            mats, mat_off, off = [], {}, 0
            for i in limbs:
                for name in self._MATS:
                    a = self.tabs[i].stage_matrix(name).reshape(-1)
                    mat_off[i, name] = off
                    mats.append(a)
                    off += a.size
            tws, tw_off, off = [], {}, 0
            for i in limbs:
                t = self.tabs[i]
                for fwd, (w, ws), wm in ((True, t.t1, t.t1m), (False, t.t1i, t.t1im)):
                    tw_off[i, fwd, False], tw_off[i, fwd, True] = off, off + 2 * w.size
                    tws += [w.reshape(-1), ws.reshape(-1), wm.reshape(-1)]
                    off += 3 * w.size
            d = self._dev[key] = dict(
                mats=torch.as_tensor(np.concatenate(mats), device=device),
                tw=torch.as_tensor(np.concatenate(tws).view(np.int64), device=device),
                mat_off=mat_off, tw_off=tw_off, limbs=set(limbs), info={})
        ikey = (tuple(sel), forward, mont)
        if ikey not in d["info"]:
            first, second = ("a1", "a2") if forward else ("a2i", "a1i")
            rows = lambda name, with_tw: [
                [d["mat_off"][i, name], self.tabs[i].nd, self.tabs[i].q,
                 self.tabs[i].plan.qinv_r, d["tw_off"][i, forward, mont] if with_tw else 0,
                 self.tabs[i].qinv64] for i in sel]
            d["info"][ikey] = tuple(
                torch.as_tensor(u64_to_i64(rows(name, tw)), device=device)
                for name, tw in ((first, True), (second, False)))
        return (d["mats"], d["tw"]) + d["info"][ikey]

    def plain_mats(self, sel, name, device) -> torch.Tensor:
        """The stage matrices of limbs ``sel`` stacked, int8 (L, nd·m, nd·m)."""
        return torch.as_tensor(np.stack([self.tabs[i].stage_matrix(name) for i in sel]),
                               device=device)

    def twiddles(self, sel, forward):
        """The twiddle (w, w_shoup) of limbs ``sel``, uint64 (L, m, cols)."""
        pairs = [self.tabs[i].t1 if forward else self.tabs[i].t1i for i in sel]
        return tuple(np.stack([p[j] for p in pairs]) for j in (0, 1))


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
        self.streamed = StreamedChain(tables.tabs)

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
        return _by_group(
            self.tables, x, sel, lambda i: route(self.n, self.tabs[i].nd),
            lambda part, sub, r: (self.big._run(part, forward, sub) if r == "big"
                                  else self.fused(part, forward, sub, r == "fused_mont")))

    def fused(self, x: torch.Tensor, forward: bool, sel, mont: bool = False) -> torch.Tensor:
        """The fused route over limbs ``sel`` of the chain, whatever
        :func:`route` says: kernel 1 (kernel 1b with ``mont``) on the card,
        :func:`.mxu_ntt.mxu_ntt_limb` per limb on the CPU."""
        if not x.is_cuda:
            fn = mxu_ntt_limb if forward else mxu_intt_limb
            return torch.stack([fn(x[..., k, :], self.tabs[i], mont)
                                for k, i in enumerate(sel)], dim=-2)
        lead, L = x.shape[:-2], len(sel)
        xb = x.reshape(-1, L, self.n).contiguous()
        B = xb.shape[0]
        mats, tw, info1, info2 = self.tables.device(x.device, sel, forward, mont)
        m1, m2 = (self.n1, self.n2) if forward else (self.n2, self.n1)
        y = torch.empty((B, L, m2, m1), dtype=torch.int64, device=x.device)
        ntt_stage(xb.view(B, L, m1, m2), y, mats, info1, tw, twiddle=True, mont=mont)
        z = torch.empty_like(y)
        ntt_stage(y, z, mats, info2, tw, twiddle=False, mont=mont)
        return z.reshape(lead + (L, self.n))
