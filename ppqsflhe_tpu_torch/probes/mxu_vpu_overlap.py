"""Kernel 7: does an int8 tensor-core product run alongside an independent
32-bit integer chain on one SM of the card?

Twin of ``probes/mxu_vpu_overlap.py`` (its TPU kernel ``make``, pallas_call
at :59). Per cell k of X8 (K, nd·m, c) int8, with x = X8[k] ^ carry and its
column halves x0, x1, the output (K, m, c) holds uint32 bit patterns (in an
int32 tensor) of one of four orders:

- ``mxu``:    [A[:m] @ x0, A[:m] @ x1] (int8 products, int32 sums);
- ``vpu``:    :func:`vpu_chain` of x[:m] sign-extended, per half;
- ``serial``: dot0; chain(dot0); dot1; chain(dot1);
- ``inter``:  dot0; dot1; chain(dot0); chain(dot1) (the kernel runs
  chain(dot0) in slices between dot1's product issues).

``serial`` and ``inter`` give the same output; the order is what is timed.
``carry`` is the previous call's output: the low byte of its element
[0, 0, 0], as an int8 (what XLA's uint32 → int8 convert gives), is XORed
into x, so chained calls depend on each other. The TPU kernel contracted
all nd·m rows of A and sliced the m rows it stored (``:38-40``,
``:47-53``); the port computes only the m rows that reach the output, 2·m·
(nd·m)·c int8 operations per cell.

:func:`probe` launches ``csrc/overlap_probe.cu`` on CUDA tensors and runs
:func:`probe_plain` on CPU tensors. The kernel issues the products as
``wgmma`` from shared memory: each cell's m rows are split over m/128 CTAs
(:func:`cta_grid`: two a cell at m=256, so K=64 cells fill 128 of the
H100's 132 SMs), each CTA holding two consumer warpgroups (64 rows each)
and one producer warpgroup (:data:`WARPGROUPS`); :func:`check_kernel_shapes`
states which shapes it takes. :func:`measure` times the four kinds
scan-marginally, with the TPU script's metric: (t(R_HI) − t(R_LO)) /
(R_HI − R_LO) / K µs per cell over chained launches, each chain one CUDA
graph whose every output is held to :func:`probe_plain` after every
replay. Run on the card::

    python -m ppqsflhe_tpu_torch.probes.mxu_vpu_overlap
"""

from __future__ import annotations

import torch

from ..ops import cuda_lib

M, ND, C, K_CELLS = 256, 6, 256, 64      # the TPU probe's shapes
BM, KC = 128, 128                        # kernel 7: rows per CTA, contraction bytes per step
WARPGROUPS = {"consumer": 2, "producer": 1}   # per CTA
R_LO, R_HI = 50, 250
KINDS = ("mxu", "vpu", "serial", "inter")
ROUNDS = 20
_MASK = 0xFFFFFFFF
POISON = 0x5A5A5A5A                      # written over a checked output
launches = 0


def carry_byte(prev: torch.Tensor | None) -> int:
    """The int8 that the previous output carries: its element [0, 0, 0] as
    uint32, converted to int8 by its low byte (two's complement)."""
    if prev is None:
        return 0
    b = int(prev.reshape(-1)[0].item()) & 0xFF
    return b - 256 if b >= 128 else b


def vpu_chain(x: torch.Tensor) -> torch.Tensor:
    """20 rounds of x = (x·2654435761 + i) ^ (x >> 7) on uint32 values held
    in int64 (the product wraps mod 2^64; the mask keeps the low 32 bits)."""
    for i in range(ROUNDS):
        x = ((x * 2654435761 + i) & _MASK) ^ (x >> 7)
    return x


def _bits32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values in int64 → the same bits in int32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def probe_plain(kind: str, x8: torch.Tensor, a: torch.Tensor,
                carry: torch.Tensor | None = None, m: int = M) -> torch.Tensor:
    """The plain version, on any device: ``X8 ^ carry`` literally, the
    products through ``torch._int_mm`` (all cells in one call), the chain in
    int64."""
    if kind not in KINDS:
        raise ValueError(f"kind={kind!r}: one of {KINDS}")
    K, W, c = x8.shape
    x = x8 ^ torch.tensor(carry_byte(carry), dtype=torch.int8)
    if kind == "vpu":
        return _bits32(vpu_chain(x[:, :m].to(torch.int64) & _MASK))
    flat = x.permute(1, 0, 2).reshape(W, K * c)
    p = torch._int_mm(a[:m].contiguous(), flat).reshape(m, K, c).permute(1, 0, 2)
    p = p.to(torch.int64) & _MASK
    return _bits32(p if kind == "mxu" else vpu_chain(p))


def check_kernel_shapes(K: int, W: int, m: int, c: int) -> None:
    """Raise ValueError unless kernel 7 takes x8 (K, W, c) at m output rows:
    c == 256 (two halves of 128 columns), m a positive multiple of 128 (the
    rows of one CTA), W a multiple of 128 (one contraction step), m <= W."""
    if K < 1 or c != 2 * 128 or m < BM or m % BM or W % KC or m > W:
        raise ValueError(f"probe kernel needs K >= 1, c == 256, m a positive multiple of {BM}, "
                         f"W a multiple of {KC} and m <= W; got K={K}, W={W}, m={m}, c={c}")


def cta_grid(K: int, m: int) -> list:
    """(cell, first output row) of each CTA, in blockIdx order: the m // 128
    CTAs of a cell are adjacent."""
    nb = m // BM
    return [(b // nb, (b % nb) * BM) for b in range(K * nb)]


def probe(kind: str, x8: torch.Tensor, a: torch.Tensor, carry: torch.Tensor | None = None,
          m: int = M) -> torch.Tensor:
    """Kernel 7 on CUDA tensors (the plain version on CPU tensors): x8
    (K, W, c) int8 with W = nd·m, a (W, W) int8, carry the previous output
    (K', m, c) int32 or None. → (K, m, c) int32 holding uint32 bits. A
    launch captured in a CUDA graph is counted by :func:`chained_ms` at each
    replay, not here."""
    global launches
    if not x8.is_cuda:
        return probe_plain(kind, x8, a, carry, m)
    if kind not in KINDS:
        raise ValueError(f"kind={kind!r}: one of {KINDS}")
    out = _launch(KINDS.index(kind), x8, a, carry, m)
    if not torch.cuda.is_current_stream_capturing():
        launches += 1
    return out


def _launch(kind_code: int, x8, a, carry, m):
    K, W, c = x8.shape
    for name, t, dt in (("x8", x8, torch.int8), ("a", a, torch.int8)):
        if t.device != x8.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"probe {name}: expected a contiguous {dt} tensor on {x8.device}")
    if a.shape != (W, W):
        raise ValueError(f"probe kernel needs a ({W}, {W}); got a {tuple(a.shape)}")
    check_kernel_shapes(K, W, m, c)
    if carry is None:
        carry = torch.zeros(1, dtype=torch.int32, device=x8.device)
    if carry.device != x8.device or carry.dtype != torch.int32 or not carry.is_contiguous():
        raise ValueError("probe carry: expected a contiguous int32 tensor on the same device")
    out = torch.empty((K, m, c), dtype=torch.int32, device=x8.device)
    lib = cuda_lib.library()
    with torch.cuda.device(x8.device):
        code = lib.ppq_overlap_probe(x8.data_ptr(), a.data_ptr(), carry.data_ptr(),
                                     out.data_ptr(), kind_code, K, W, m, c,
                                     cuda_lib.stream_of(x8))
    cuda_lib.check(code, "ppq_overlap_probe")
    return out


def inputs(device, seed: int = 0):
    """The TPU script's inputs at its shapes: A in [-100, 100), X8 in
    [0, 100), from ``numpy.random.default_rng(seed)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a = rng.integers(-100, 100, (ND * M, ND * M), dtype=np.int8)
    x8 = rng.integers(0, 100, (K_CELLS, ND * M, C), dtype=np.int8)
    return torch.from_numpy(x8).to(device), torch.from_numpy(a).to(device)


def check_chain(kind: str, x8, a, outs, m: int = M, plain=None) -> None:
    """Hold each of ``outs``, the outputs of chained launches from carry 0
    (each carrying the one before), to :func:`probe_plain` at its carry
    (bit-equal); ``plain`` caches the plain output per carry byte."""
    plain = {} if plain is None else plain
    prev = None
    for i, out in enumerate(outs):
        cb = carry_byte(prev)
        if cb not in plain:
            plain[cb] = probe_plain(kind, x8, a, prev, m)
        if not torch.equal(out, plain[cb]):
            raise AssertionError(f"kernel 7 ({kind}): chained launch {i + 1} of {len(outs)} "
                                 f"(carry {cb}) differs from probe_plain")
        prev = out


def chained_ms(kind: str, x8, a, r: int, m: int = M, reps: int = 3) -> float:
    """Best of ``reps`` CUDA-event times (ms) of ``r`` chained launches of
    the ``kind`` order, each carrying the previous one's output, captured
    once in a CUDA graph and replayed after one untimed replay: the chain
    the TPU script scans, without the host's cost per launch (the wrapper's
    Python takes longer than one launch of the ``wgmma`` kernel, so an eager
    chain would time the host). Each launch writes an output of its own;
    after every replay all ``r`` are held to the plain version
    (:func:`check_chain`) and then overwritten with :data:`POISON`, so
    every launch of the next replay must write its output anew. Each replay
    adds its ``r`` launches to ``launches``."""
    global launches
    probe(kind, x8, a, None, m)                 # outside the capture: build, attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = []
        for _ in range(r):
            outs.append(probe(kind, x8, a, outs[-1] if outs else None, m))
    best, plain = None, {}
    for rep in range(reps + 1):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        launches += r
        check_chain(kind, x8, a, outs, m, plain)
        for out in outs:
            out.fill_(POISON)
        if rep:
            ms = start.elapsed_time(stop)
            best = ms if best is None else min(best, ms)
    del graph, outs
    return best


def measure(x8, a, m: int = M, kinds=KINDS) -> dict:
    """µs per cell of each kind, scan-marginal over R_LO and R_HI chained
    launches (each chain a replayed CUDA graph, :func:`chained_ms`)."""
    us = {}
    for kind in kinds:
        t_lo, t_hi = chained_ms(kind, x8, a, R_LO, m), chained_ms(kind, x8, a, R_HI, m)
        us[kind] = (t_hi - t_lo) / (R_HI - R_LO) / x8.shape[0] * 1e3
    return us


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mxu_vpu_overlap: needs a CUDA GPU")
    x8, a = inputs(torch.device("cuda"))
    card = torch.cuda.get_device_name(0)
    for kind in KINDS:
        if not torch.equal(probe(kind, x8, a), probe_plain(kind, x8, a)):
            raise SystemExit(f"mxu_vpu_overlap: kernel 7 ({kind}) differs from probe_plain")
    for kind, v in measure(x8, a).items():
        print(f"{kind:7s}: {v:8.3f} us/cell, {v * x8.shape[0]:8.1f} us per launch ({card})")


if __name__ == "__main__":
    main()
