"""Kernels 4 and 5: the streamed NTT pair as Shoup butterflies.

The port's counterpart of ``ppqsflhe_tpu.ops.pallas_mxu_ntt.PallasMxuNttBig``
(``_stage_a``, ``_stage_b``): one four-step transform cut at its transpose
into two passes, with the same functions, shapes and interfaces. The TPU ran
each stage as an exact int8 product against a digit-sliced m×m matrix; the
matrices are products of well-known factors, and this module runs those
factors instead, in the names of :mod:`.fourstep` (ψ1 = ψ^{n2}, ω1 = ψ1²,
ω2 = ψ^{2·n1}):

- **stage A forward**: x ⊙ ψ1^{j1} down the rows, the Pease GS network of
  ω1 (``pgs1``), then the lazy Shoup twiddle ``t1`` at the block's columns;
- **stage B forward**: t ⊙ ψ^{j2} along its contiguous axis, the GS network
  of ω2 (``pgs2``) down the transposed block, one csub;
- **stage A inverse**: one csub by 2q (the digit stage took inputs < 4q, the
  network keeps the Harvey invariant for inputs < 2q), the CT network of
  ω2⁻¹ (``pct2``), ⊙ ψ^{-j2}, then the lazy twiddle ``t1i``;
- **stage B inverse**: the CT network of ω1⁻¹ (``pct1``), then a strict
  Shoup product by N⁻¹·ψ1^{-j1}.

Stage B's outputs are canonical, so they equal the digit stages' bit for
bit. Stage A's outputs are < 2q and ≡ the digit stage's mod q, but the lazy
representative differs (the digit stage ends in a REDC, this one in a Shoup
product): the stage's contract has always been "< 2q, ≡ mod q", and its one
consumer, stage B, ends canonical.

:func:`stage_a_plain` and :func:`stage_b_plain` are the plain versions (int64,
any device), composed of :func:`.fourstep._col_gs_cg` / ``_col_ct_cg`` and
the Shoup products of :mod:`..core.modarith`, one limb at a time through
:func:`first_stage` and :func:`second_stage`, which the fused route's plain
stages (kernels 1 and 1b, :mod:`.cuda_mxu_ntt`) share. :func:`stage_a` and
:func:`stage_b` launch the kernels of ``csrc/streamed_ntt.cu``, which run the
plain versions' butterfly graph (the same pairs, twiddles and lazy steps),
so both stages are bit-equal to their plain versions. :class:`StreamedChain`
uploads the tables of all four kernels.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import primes
from ..core.modarith import mont_mul_lazy, shoup_mul, shoup_mul_lazy, u64_to_i64
from . import cuda_lib
from .fourstep import _col_ct_cg, _col_gs_cg, _pair, _pease, _powers

launches_stage_a = 0  # kernel 4 launches since the last reset
launches_stage_b = 0  # kernel 5 launches
INFO = 4              # per limb: q, vector, root-row and twiddle offsets in the table buffer
TILE = 16             # csrc/butterfly.cuh TC_MAX: the widest tile, columns (stage A) or rows
#                       (stage B) a block; a narrower block is a power of two below it
SIZES = (8, 16, 32, 64, 128, 256)   # the m the kernels take: m/16 threads of 16 values a
#                                     column, or one thread a column at m = 8 and 16


NARROW = (1, 2, 4, 8)   # the narrower tiles of kernels 4 and 5: every power of two below 16
FUSED_NARROW = (8,)     # kernels 1, 1b and 6's narrower tile, at m ≤ 16 only (the 8-column
#                         stages of N = 2^6 and 2^7)


def tile_width(w: int, what: str, narrow: tuple = NARROW) -> int:
    """The tile width of a kernel's block over w columns or rows: 16 for
    whole 16-wide tiles, else w itself when it is one of the ``narrow``
    widths (:data:`NARROW` for kernels 4 and 5, :data:`FUSED_NARROW` or none
    for kernels 1, 1b and 6). csrc/butterfly.cuh ``with_tile`` is its twin.
    Raises ValueError, naming ``what``, for any other w."""
    if w > 0 and w % TILE == 0:
        return TILE
    if w in narrow:
        return w
    widths = f" or a power of two in {list(narrow)}" if narrow else ""
    raise ValueError(f"{what}: {w} is not whole {TILE}-wide tiles{widths}")


@dataclass
class StreamedTables:
    """One limb's tables, each a (value, Shoup companion) uint64 pair."""

    q: int
    n1: int
    n2: int
    twist1: tuple     # (n1,): ψ1^{j1}, stage A forward, before the network
    twist2: tuple     # (n2,): ψ^{j2}, stage B forward, before the network
    itwist2: tuple    # (n2,): ψ^{-j2}, stage A inverse, after the network
    itwist1: tuple    # (n1,): N^{-1}·ψ1^{-j1}, stage B inverse, strict
    pgs1: tuple       # (S1, n1/2) Pease rows of ω1
    pgs2: tuple       # (S2, n2/2) of ω2
    pct2: tuple       # (S2, n2/2) of ω2^{-1}
    pct1: tuple       # (S1, n1/2) of ω1^{-1}
    t1: tuple         # (n1, n2): ω^{rev1(r)·j2}, stage A forward's twiddle
    t1i: tuple        # (n2, n1): its inverse, stage A inverse's
    t1m: tuple        # (t1's w·2^64 mod q,): the Montgomery twiddle (no companion)
    t1im: tuple       # (t1i's w·2^64 mod q,)
    qinv64: int       # -q^{-1} mod 2^64, the Montgomery twiddle's constant
    _dev: dict = field(default_factory=dict, repr=False)

    @staticmethod
    def build(tabs) -> "StreamedTables":
        """From a limb's :class:`.mxu_ntt.MxuNttTables`: its q, ψ (a
        primitive 2N-th root of unity), shape and twiddles."""
        n, n1, n2, q, psi = tabs.n, tabs.n1, tabs.n2, tabs.q, tabs.psi
        ipsi = primes.mod_inverse(psi, q)
        psi1, ipsi1 = pow(psi, n2, q), pow(ipsi, n2, q)
        om1, om2 = psi1 * psi1 % q, pow(psi, 2 * n1, q)
        iom1, iom2 = primes.mod_inverse(om1, q), primes.mod_inverse(om2, q)
        return StreamedTables(
            q=q, n1=n1, n2=n2,
            twist1=_pair(_powers(1, psi1, n1, q), q), twist2=_pair(_powers(1, psi, n2, q), q),
            itwist2=_pair(_powers(1, ipsi, n2, q), q),
            itwist1=_pair(_powers(primes.mod_inverse(n, q), ipsi1, n1, q), q),
            pgs1=_pair(_pease(n1, om1, q), q), pgs2=_pair(_pease(n2, om2, q), q),
            pct2=_pair(_pease(n2, iom2, q), q), pct1=_pair(_pease(n1, iom1, q), q),
            t1=tabs.t1, t1i=tabs.t1i, t1m=(tabs.t1m,), t1im=(tabs.t1im,), qinv64=tabs.qinv64)

    def tensor(self, name: str, device) -> tuple:
        """Table ``name`` as an int64 (value, companion) pair on ``device``
        (the Montgomery twiddles: a 1-tuple)."""
        key = (name, str(device))
        if key not in self._dev:
            self._dev[key] = tuple(torch.as_tensor(a.view(np.int64), device=device)
                                   for a in getattr(self, name))
        return self._dev[key]

    def blocks(self, forward: bool) -> dict:
        """The kernels' tables of one direction as flat uint64 blocks, each a
        pair stored values then companions: the first stage's and the
        second's vector (length m) and Pease row 0 (root^i, i < m/2: every
        later row repeats its entries, W_s[i] = W_0[(i >> s) << s]), and the
        first stage's twiddle, as a Shoup pair (``tw``: kernels 4 and 1) and
        as the Montgomery table alone (``twm``: kernel 1b)."""
        flat = lambda pair: np.concatenate([a.reshape(-1) for a in pair])
        vec_a, root_a, vec_b, root_b, tw, twm = (
            (self.twist1, self.pgs1, self.twist2, self.pgs2, self.t1, self.t1m) if forward else
            (self.itwist2, self.pct2, self.itwist1, self.pct1, self.t1i, self.t1im))
        return dict(vec_a=flat(vec_a), root_a=flat(tuple(a[0] for a in root_a)),
                    vec_b=flat(vec_b), root_b=flat(tuple(a[0] for a in root_b)), tw=flat(tw),
                    twm=flat(twm))


def _vec(t: StreamedTables, name: str, device):
    w, ws = t.tensor(name, device)
    return w[:, None], ws[:, None]


def first_stage(y: torch.Tensor, t: StreamedTables, forward: bool, col0: int = 0,
                mont: bool = False) -> torch.Tensor:
    """One limb's first column stage down axis -2 of y (B, m, c), values
    < 4q → (B, m, c), values < 2q: columns [col0, col0 + c) of the limb's
    twiddle table, Shoup or, with ``mont``, Montgomery."""
    dev, q, c = y.device, t.q, y.shape[-1]
    if forward:
        y = _col_gs_cg(shoup_mul_lazy(y, *_vec(t, "twist1", dev), q), t.tensor("pgs1", dev), q)
    else:
        y = _col_ct_cg(torch.where(y >= 2 * q, y - 2 * q, y), t.tensor("pct2", dev), q)
        y = shoup_mul_lazy(y, *_vec(t, "itwist2", dev), q)
    if mont:
        (wm,) = t.tensor("t1m" if forward else "t1im", dev)
        return mont_mul_lazy(y, wm[:, col0:col0 + c], q, int(u64_to_i64(t.qinv64)))
    w, ws = t.tensor("t1" if forward else "t1i", dev)
    return shoup_mul_lazy(y, w[:, col0:col0 + c], ws[:, col0:col0 + c], q)


def second_stage(y: torch.Tensor, t: StreamedTables, forward: bool) -> torch.Tensor:
    """One limb's second column stage down axis -2 of y (B, m, c), values
    < 2q → (B, m, c) canonical residues."""
    dev, q = y.device, t.q
    if forward:
        y = _col_gs_cg(shoup_mul_lazy(y, *_vec(t, "twist2", dev), q), t.tensor("pgs2", dev), q)
        return torch.where(y >= q, y - q, y)
    return shoup_mul(_col_ct_cg(y, t.tensor("pct1", dev), q), *_vec(t, "itwist1", dev), q)


def stage_a_plain(x: torch.Tensor, tabs, forward: bool, col0: int = 0) -> torch.Tensor:
    """Stage A: x (B, L, m, c) int64, transformed down its m rows →
    (B, L, m, c), values < 2q, no transpose. x holds columns [col0, col0 + c)
    of each limb's twiddle table; ``tabs``: the L limbs' tables."""
    return torch.stack([first_stage(x[:, l], t, forward, col0) for l, t in enumerate(tabs)],
                       dim=1)


def stage_b_plain(t: torch.Tensor, tabs, forward: bool) -> torch.Tensor:
    """Stage B: t (B, L, rows, m) int64, values < 2q, transformed along its
    last axis → (B, L, m, rows) canonical residues."""
    return torch.stack([second_stage(t[:, l].transpose(-1, -2), tb, forward)
                        for l, tb in enumerate(tabs)], dim=1)


def _check(name, x, y, y_shape, tabs, info, m, aligned):
    if m not in SIZES:
        raise ValueError(f"{name} kernel takes m in {SIZES}, got m={m}")
    cuda_lib.require(x, f"{name} x")
    cuda_lib.require(y, f"{name} y", y_shape)
    cuda_lib.require(tabs, f"{name} tables")
    cuda_lib.require(info, f"{name} info", (x.shape[1], INFO))
    if len({t.device for t in (x, y, tabs, info)}) != 1:
        raise ValueError(f"{name} tensors must share one device")
    if aligned and x.data_ptr() % 16:
        raise ValueError(f"{name} x must be 16-byte aligned (its 16-byte copies)")


def stage_a(x: torch.Tensor, y: torch.Tensor, tabs: torch.Tensor, info: torch.Tensor,
            forward: bool, tw_cols: int, col0: int = 0) -> torch.Tensor:
    """Kernel 4: x (B, L, m, c) int64 → y (B, L, m, c), values < 2q, no
    transpose. Limb l's twiddle table is (m, tw_cols) at
    ``tabs[info[l, 3]:]`` (its companions m·tw_cols further on) and x holds
    its columns [col0, col0 + c); ``info[l]`` = (q, vector, Pease row 0,
    twiddle offsets). c is whole 16-column tiles or a power of two below 16,
    col0 a multiple of the tile width; raises ValueError otherwise, and for
    m outside :data:`SIZES`, before any build or launch."""
    global launches_stage_a
    B, L, m, c = x.shape
    if col0 < 0 or col0 + c > tw_cols:
        raise ValueError(f"stage_a: columns [{col0}, {col0 + c}) outside a "
                         f"{tw_cols}-column twiddle table")
    tc = tile_width(c, "stage_a columns")
    if col0 % tc:
        raise ValueError(f"stage_a: columns [{col0}, {col0 + c}) do not fall on whole "
                         f"{tc}-column tiles")
    _check("stage_a", x, y, (B, L, m, c), tabs, info, m, tc > 1)
    lib = cuda_lib.library()
    with torch.cuda.device(x.device):
        code = lib.ppq_streamed_stage_a(x.data_ptr(), y.data_ptr(), tabs.data_ptr(),
                                        info.data_ptr(), B, L, m, c, tw_cols, col0,
                                        int(forward), cuda_lib.stream_of(x))
    launches_stage_a += 1
    cuda_lib.check(code, "ppq_streamed_stage_a")
    return y


def stage_b(t: torch.Tensor, y: torch.Tensor, tabs: torch.Tensor, info: torch.Tensor,
            forward: bool) -> torch.Tensor:
    """Kernel 5: t (B, L, rows, m) int64, values < 2q, transformed along its
    last axis → y (B, L, m, rows) canonical residues. rows is whole 16-row
    tiles or a power of two below 16."""
    global launches_stage_b
    B, L, rows, m = t.shape
    tile_width(rows, "stage_b rows")
    _check("stage_b", t, y, (B, L, m, rows), tabs, info, m, True)
    lib = cuda_lib.library()
    with torch.cuda.device(t.device):
        code = lib.ppq_streamed_stage_b(t.data_ptr(), y.data_ptr(), tabs.data_ptr(),
                                        info.data_ptr(), B, L, m, rows, int(forward),
                                        cuda_lib.stream_of(t))
    launches_stage_b += 1
    cuda_lib.check(code, "ppq_streamed_stage_b")
    return y


class StreamedChain:
    """The butterfly tables over a modulus chain, of the streamed pair and
    the fused route alike (kernels 4, 5, 1 and 1b take one info-row layout):
    each limb's built on first use from the chain's
    :class:`.mxu_ntt.MxuNttTables`, and uploaded to a device for the limbs
    asked for so far (a call naming a new limb re-uploads the union, so the
    offsets in the info rows change)."""

    def __init__(self, tabs):
        self.mxu_tabs = tabs
        self._limbs: dict = {}
        self._dev: dict = {}

    def limb(self, i: int) -> StreamedTables:
        if i not in self._limbs:
            self._limbs[i] = StreamedTables.build(self.mxu_tabs[i])
        return self._limbs[i]

    def device(self, device, sel, forward: bool, mont: bool = False):
        """(tables, first-stage info, second-stage info) on ``device`` for
        limbs ``sel`` in one direction; with ``mont`` the first stage's
        twiddle offset points at the Montgomery table (kernel 1b)."""
        key = str(device)
        d = self._dev.get(key)
        if d is None or not set(sel) <= d["limbs"]:
            limbs = sorted(set(sel) | (d["limbs"] if d else set()))
            parts, offs, off = [], {}, 0
            for i in limbs:
                for fwd in (True, False):
                    for name, a in self.limb(i).blocks(fwd).items():
                        offs[i, fwd, name] = off
                        parts.append(a)
                        off += a.size
            # a captured CUDA graph (fl/compiled.py) reads tables by address:
            # the ones replaced here stay alive
            d = self._dev[key] = dict(
                tabs=torch.as_tensor(np.concatenate(parts).view(np.int64), device=device),
                offs=offs, limbs=set(limbs), info={},
                retired=[*d["retired"], d["tabs"], d["info"]] if d else [])
        ikey = (tuple(sel), forward, mont)
        if ikey not in d["info"]:
            o = d["offs"]
            tw = "twm" if mont else "tw"
            rows = lambda stage, first: [[self.mxu_tabs[i].q, o[i, forward, "vec_" + stage],
                                          o[i, forward, "root_" + stage],
                                          o[i, forward, tw] if first else 0] for i in sel]
            d["info"][ikey] = tuple(torch.as_tensor(u64_to_i64(rows(s, s == "a")), device=device)
                                    for s in ("a", "b"))
        return (d["tabs"],) + d["info"][ikey]
