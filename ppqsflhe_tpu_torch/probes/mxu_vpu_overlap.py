"""Kernel 7: does an int8 tensor-core product run alongside an independent
32-bit integer chain on one SM of the card?

Twin of ``probes/mxu_vpu_overlap.py`` (its TPU kernel ``make``, pallas_call
at :59). Per cell k of X8 (K, nd·m, c) int8, with x = X8[k] ^ carry and its
column halves x0, x1, the output (K, m, c) holds uint32 bit patterns (in an
int32 tensor) of one of four orders:

- ``mxu``:    [A[:m] @ x0, A[:m] @ x1] (int8 products, int32 sums);
- ``vpu``:    :func:`vpu_chain` of x[:m] sign-extended, per half;
- ``serial``: dot0; chain(dot0); dot1; chain(dot1);
- ``inter``:  dot0; dot1; chain(dot0); chain(dot1).

``serial`` and ``inter`` give the same output; the order is what is timed.
``carry`` is the previous call's output: the low byte of its element
[0, 0, 0], as an int8 (what XLA's uint32 → int8 convert gives), is XORed
into x, so chained calls depend on each other. The TPU kernel contracted
all nd·m rows of A and sliced the m rows it stored (``:38-40``,
``:47-53``); the port computes only the m rows that reach the output, 2·m·
(nd·m)·c int8 operations per cell.

:func:`probe` launches ``csrc/overlap_probe.cu`` (one CTA per cell: at
K=64 the call fills 64 of the H100's 132 SMs, each SM working on its cell
for the whole launch) on CUDA tensors and runs :func:`probe_plain` on CPU
tensors. :func:`measure` times the four kinds scan-marginally, with the TPU
script's metric: (t(R_HI) − t(R_LO)) / (R_HI − R_LO) / K µs per cell over
chained launches. Run on the card::

    python -m ppqsflhe_tpu_torch.probes.mxu_vpu_overlap
"""

from __future__ import annotations

import torch

from ..ops import cuda_lib

M, ND, C, K_CELLS = 256, 6, 256, 64      # the TPU probe's shapes
R_LO, R_HI = 50, 250
KINDS = ("mxu", "vpu", "serial", "inter")
ROUNDS = 20
_MASK = 0xFFFFFFFF
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


def probe(kind: str, x8: torch.Tensor, a: torch.Tensor, carry: torch.Tensor | None = None,
          m: int = M) -> torch.Tensor:
    """Kernel 7 on CUDA tensors (the plain version on CPU tensors): x8
    (K, W, c) int8 with W = nd·m, a (W, W) int8, carry the previous output
    (K', m, c) int32 or None. → (K, m, c) int32 holding uint32 bits."""
    global launches
    if not x8.is_cuda:
        return probe_plain(kind, x8, a, carry, m)
    if kind not in KINDS:
        raise ValueError(f"kind={kind!r}: one of {KINDS}")
    K, W, c = x8.shape
    for name, t, dt in (("x8", x8, torch.int8), ("a", a, torch.int8)):
        if t.device != x8.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"probe {name}: expected a contiguous {dt} tensor on {x8.device}")
    if a.shape != (W, W) or c != 256 or m % 64 or W % 64 or not m <= W:
        raise ValueError(f"probe kernel needs a ({W}, {W}), c == 256, m and W multiples of "
                         f"64, m <= W; got a {tuple(a.shape)}, c={c}, m={m}, W={W}")
    if carry is None:
        carry = torch.zeros(1, dtype=torch.int32, device=x8.device)
    if carry.device != x8.device or carry.dtype != torch.int32 or not carry.is_contiguous():
        raise ValueError("probe carry: expected a contiguous int32 tensor on the same device")
    out = torch.empty((K, m, c), dtype=torch.int32, device=x8.device)
    lib = cuda_lib.library()
    with torch.cuda.device(x8.device):
        code = lib.ppq_overlap_probe(x8.data_ptr(), a.data_ptr(), carry.data_ptr(),
                                     out.data_ptr(), KINDS.index(kind), K, W, m, c,
                                     cuda_lib.stream_of(x8))
    launches += 1
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


def chained_ms(kind: str, x8, a, r: int, m: int = M, reps: int = 3) -> float:
    """Best of ``reps`` CUDA-event times (ms) of ``r`` launches, each
    carrying the previous one's output."""
    best = None
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        prev = None
        for _ in range(r):
            prev = probe(kind, x8, a, prev, m)
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop)
        best = ms if best is None else min(best, ms)
    return best


def measure(x8, a, m: int = M) -> dict:
    """µs per cell of each kind, scan-marginal over R_LO and R_HI chained
    launches (after one warm-up chain of each length)."""
    us = {}
    for kind in KINDS:
        chained_ms(kind, x8, a, R_LO, m, reps=1)
        chained_ms(kind, x8, a, R_HI, m, reps=1)
        t_lo, t_hi = chained_ms(kind, x8, a, R_LO, m), chained_ms(kind, x8, a, R_HI, m)
        us[kind] = (t_hi - t_lo) / (R_HI - R_LO) / x8.shape[0] * 1e3
    return us


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mxu_vpu_overlap: needs a CUDA GPU")
    x8, a = inputs(torch.device("cuda"))
    for kind, v in measure(x8, a).items():
        print(f"{kind:7s}: {v:8.2f} us/cell ({torch.cuda.get_device_name(0)})")


if __name__ == "__main__":
    main()
