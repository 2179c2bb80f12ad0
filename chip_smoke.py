#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's paths through ``ppqsflhe_tpu_torch``:

- **the server round** of ``bench.py`` (2 clients × 27 ciphertexts at
  N=2^14, the ``CkksParams.generate(n=2^14, mult_depth=2, dnum=2)`` chain),
  once in each schedule (lazy-4 and full level);
- **hoisted Galois rotations** of ``bench_rotations.py`` (R=8 rotations
  {1, 2, 4, …, 128} of one ciphertext at N=2^15 on
  ``CkksParams.generate(n=2^15, mult_depth=2, dnum=2)``: Q = 60/40/40 bits,
  P = 2 × 60 bits), plain, hoisted and as a double-hoisted rotation sum,
  plus one packed inner product;
- **the NTT north star** of ``bench_kernels.py:53-99`` (the four-step
  runner over ``first_prime_down(59, 2N)`` + 3 × 40-bit primes, chained
  transforms, forward then inverse) at N=2^14 (B=27) and N=2^16 (B=8), in
  both implementations: the digit-matmul route (kernel 1 at 2^14; kernels
  4+5 and 1b at 2^16) and the butterfly, kernel 6;
- **the server round at N=2^16** (``ring_dim: 65536`` with the reference's
  other CC settings, 8192 slots), both schedules: kernel 1b on the 40-bit
  limbs, kernels 4+5 on the 60-bit ones, 2 and 3 (at every digit count, as
  in every round); then the
  device memory of the context's NTT tables, and the big route's transforms
  on the 60-bit limbs bit-equal to kernel 6's and kernel 1b's;
- **the butterfly configuration** of the N=2^14 round (``ntt_impl="pallas"``:
  kernel 6 runs every NTT), both schedules, bit-equal to the default round;
- **the seven FL tools on files** (``ppqsflhe_tpu_torch.fl.api``) at N=2^14
  in a temporary directory: ``configs/config_cc.json`` as genCC writes it
  (radix-2, JSON container) and the same with the four-step digit-matmul
  NTT (PQWD container); two clients' GRU weights (39,041 values, 27
  ciphertexts each, one optimizer layer skipped), keyGen ×2, REkeyGen both
  ways, pk (dense v2) and sk (seeded v3) encryption, changeCipherDomain,
  aggregation, changeCipherDomain back, both decrypts; then one INDCCA hop
  under ``configs/config_cc_indcca.json``;
- **the multikey round** of ``bench_multikey.py`` (``BASELINE.json`` config
  5) through ``ppqsflhe_tpu_torch.bench.multikey``: 16 clients × 154
  ciphertexts (the stacked LSTM's 1,091,101 values) at N=2^14, 15 PREs into
  the hub, FedAvg ÷16, 15 PREs out, in both schedules; the whole average
  decrypted under the hub's key and the outbound ciphertexts of clients 0
  and 14 under theirs (error < 1e-3); ms per round, rounds/s, device ms
  by kernel, host enqueue and idle share;
- **threshold CKKS** at 16 parties on the same chain: the CRS (its SHA-256
  equal to the JAX package's), 16 key shares and the joint key, each
  party's 154 ciphertexts encrypted under it, ``multikey.aggregate_local``,
  16 batched partial decryptions and the fusion (the error's RMS within
  0.9–1.1 σ = √(16·N/6)·2^30/Δ and its max below 6 σ; below 1e-3 with no
  flood), then Shamir 9-of-16: the sets {1..9} and {8..16} decrypt by the
  same gate at 9 parties, {1..8} does not (max error > 1);
- **kernel 7**, the tensor-core / integer-chain overlap probe of
  ``probes/mxu_vpu_overlap.py`` at its shapes (K=64 cells, m=256, nd=6,
  c=256): µs/cell for its four orders, scan-marginal over chained launches
  (each chain one CUDA graph, every launch's output held to the plain
  version after every replay), the ``wgmma`` design's split (CTAs a cell,
  warpgroups a CTA), the mxu order's int8 rate and the share of the
  possible overlap. Its JSON rows carry the scan's µs per launch as
  ``ms`` (``"timing": "scan"``) and the profiler's per call beside it;
- **the orchestrated FL loop** (``ppqsflhe_tpu_torch.orchestration``,
  local GRU training at full width, the artifact server, the rounds) in
  three runs, each fail-fast in a temporary directory on numpy-seeded
  synthetic CSVs (hourly over July 2024; the reference's are not in the
  repository): A, ``configs/oConfig.example.json`` (PRE, 2 clients over
  http, lazy levels, radix-2) cut to 2 rounds (the second through
  ``resume``) and 3 epochs; B, the twin of ``bench_orchestrated.py``
  (``bench/orchestrated.py``: reference chain, PQWD wire, no training); C,
  ``configs/oConfig.threshold.example.json`` (4 clients) for 1 round of 3
  epochs with ``"ntt_backend": "fourstep"`` added. Gates: no client dropped
  (a kernel failure must not pass as a dropout); each client's decrypt
  equals the mean of the exported weights within 1e-3 (C: within the
  flood's σ, phase 8's gate) and the clients agree; round 2 of A starts
  from round 1's decrypt; round 1 lowers every client's validation MSE;
  the GRU forward on the card is within 1e-4 of the CPU's; kernels 2 and 3
  (A, B) and 1 (C) launched and are bit-equal at the run's shapes. Then
  each round's per-step table (the step log), ms per training step and
  epoch, and the device's idle share over one epoch and one warm round
  of B;
- **the bench twins** (``ppqsflhe_tpu_torch.bench``): ``server_round`` (the
  twin of ``bench.py``) in all five schedules, ``rotations``
  (``bench_rotations.py``), ``kernels`` (``bench_kernels.py``: the NTT north
  star and the key switch on the 60/40/40 chain and on the FLEXIBLEAUTOEXT
  chain, ``extra_mod_bits=20``) and ``sizes`` (``bench_sizes.py``), each
  printing its JSON line (``[twin json]``) behind its gates, then one
  changeCipherDomain and aggregation on the OpenFHE cereal wire
  (``wire="openfhe"``), parsed back and decrypted (< 1e-3); kernels 1, 2
  and 3 at the FLEXIBLEAUTOEXT chain's shapes (the 20-bit limb, the digit
  {q2, q3}, nd=2 over LK=6) are held to their plain versions first. The
  phase prints its seconds.

For each path:

1. sets up seeded keys and ciphertexts on the card;
2. runs each hand-written kernel and its plain torch version on the same
   inputs at the path's shapes, requires bit-equal outputs, and times both:
   device time per call from ``torch.profiler``'s kernel events, beside the
   CUDA-event wall mean of back-to-back calls (which reads the host's cost
   per call when the kernel is short);
3. resets the kernels' launch counters, drives the path, requires every
   kernel of the path to have launched, and checks the decrypted outputs
   with the reference's gates (bench.py: error < 1e-3; bench_rotations.py:
   hoisted error < 1e-3, plain bit-equal to hoisted, rotation sum < 1e-2;
   the inner product within 1e-3 of np.dot);
4. times it: ms/round per schedule, µs/rotation for plain, hoisted and
   rotation sum (CUDA events, median of 20 after warm-up), µs per limb-NTT
   and limb-NTT/s (profiler device time and CUDA-event wall), ms per FL
   tool (host clock around the call, file I/O included, synchronized) and
   the server tools' device ms, µs/cell of the probe.

The file round's gates: decrypt error < 1e-3 against the plaintext mean in
both contexts, changeCipherDomain's document bit-equal to the in-memory
``change_cipher_domain_batch`` on the same loaded ciphertexts, the
radix-2 round launching kernels 2 and 3 and no NTT kernel, the four-step
round kernels 1, 2 and 3; the INDCCA hop's error RMS below √(N/2)·2^-10
(the flooding's cost per hop, ``docs/SECURITY.md:58``) and its largest
value below four times that.

Each kernel row carries its bound: the least time the card could take for
the same work, the larger of the bytes it must move (each input read once,
each output written once) over 3.35 TB/s and its int8 operations over
1,979 T/s (H100 SXM; the 64-bit integer work of the butterflies and base
extensions has no published rate, so their bound is the bytes). The rows of
kernels 1, 1b, 4 and 5, Shoup butterflies on this card, also print the floor
of the TPU's digit method for the same stages (its int8 operations at 1,979
T/s); kernels 1 and 1b are checked per transform (and once against the digit
transform) and, on the NTT loop's inputs, per stage. No PyTorch
call computes an NTT, base extension or key inner product mod q, so
``library_ms`` is null in those rows; the probe's mxu row carries the time
of one ``torch._int_mm`` over the same cells (their x permuted into one
operand before the timed window), the faster of that operand stored
row-major and stored K-major.

Then it prints a JSON line of per-kernel results, the card line, and finally
``{"ok": true, "device": {...}}``. Any failure raises (exit code ≠ 0). Needs
one CUDA device and nvcc; it refuses to run without them and never gives way
to a plain version. Run from the repository root:

    python3 chip_smoke.py [--profile]

``--profile`` adds a torch.profiler table of device time per kernel for one
round of each schedule and one hoisted rotation pass.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

N_ROUND = 1 << 14
N_ROT = 1 << 15
N_BIG = 1 << 16      # the CLI's ring_dim: 65536
SLOTS = 8192         # the reference's batch_size
NTT_SIZES = ((1 << 14, 4, 27), (1 << 16, 4, 8))   # (N, L, B) of bench_kernels.py:53
NTT_CHAIN = 20       # chained transforms per implementation and direction
N_CTS = 27           # ciphertexts per client (the reference payload's count)
ERR_GATE = 1e-3      # bench.py's gate; bench_rotations.py's for a rotation
SUM_GATE = 1e-2      # bench_rotations.py's gate for the rotation sum
SEED = 7             # keys, noise and payloads
ROUNDS = 20          # timed repetitions
ROTS = [1, 2, 4, 8, 16, 32, 64, 128]
MK_CLIENTS = 16      # bench_multikey.py's clients (BASELINE.json config 5)
TH_PARTIES, TH_T = 16, 9     # threshold: N-of-N at 16 parties, t-of-N at 9 of 16
# the threshold CRS seed (its high word non-zero) and the SHA-256 of the
# JAX package's CRS residues for it on the N=2^14 chain, four-step order
# (tests/test_torch_jax_prng.py takes it from the JAX package on the CPU)
CRS_SEED = (7 << 32) | 2026
CRS_SHA256 = "6f902f668151684407918f6106dc26d26b1438e95d8cb2880f3e4cebb6c71b62"
K1, K2, K3 = ("ppqsflhe_tpu/ops/pallas_mxu_ntt.py:390", "ppqsflhe_tpu/ops/pallas_ext.py:167",
              "ppqsflhe_tpu/ops/pallas_ks.py:127")
K4, K5 = "ppqsflhe_tpu/ops/pallas_mxu_ntt.py:512", "ppqsflhe_tpu/ops/pallas_mxu_ntt.py:566"
K1B, K6 = "ppqsflhe_tpu/ops/pallas_mxu_ntt.py:347", "ppqsflhe_tpu/ops/pallas_ntt.py:207"
SRC_NTT = "ppqsflhe_tpu_torch/csrc/mxu_ntt.cu"
SRC_STREAMED = "ppqsflhe_tpu_torch/csrc/streamed_ntt.cu"
SRC_FS = "ppqsflhe_tpu_torch/csrc/fourstep_ntt.cu"
SRC_EXT = "ppqsflhe_tpu_torch/csrc/base_ext.cu"
SRC_KS = "ppqsflhe_tpu_torch/csrc/ks_ip.cu"
SRC_PROBE = "ppqsflhe_tpu_torch/csrc/overlap_probe.cu"
K7 = "probes/mxu_vpu_overlap.py:59"
# launch counter → (module under ppqsflhe_tpu_torch, attribute, kernel symbol)
COUNTERS = {
    "mxu_ntt": ("ops.cuda_mxu_ntt", "launches", "mxu_ntt_stage_kernel"),
    "mxu_ntt_mont": ("ops.cuda_mxu_ntt", "launches_mont", "mxu_ntt_stage_mont_kernel"),
    "streamed_stage_a": ("ops.streamed_ntt", "launches_stage_a", "streamed_stage_a_kernel"),
    "streamed_stage_b": ("ops.streamed_ntt", "launches_stage_b", "streamed_stage_b_kernel"),
    "base_extend": ("ops.cuda_ext", "launches", "base_extend_kernel"),
    "ks_inner_product": ("ops.cuda_ks", "launches", "ks_ip_kernel"),
    "fourstep_ntt": ("ops.cuda_ntt", "launches", "fourstep_ntt_kernel"),
    "overlap_probe": ("probes.mxu_vpu_overlap", "launches", "overlap_probe_kernel"),
}
HBM_BPS = 3.35e12    # H100 SXM device memory, bytes/s
INT8_OPS = 1.979e15  # H100 SXM dense int8 tensor-core ops/s (a multiply-add is 2)


def bound(work) -> tuple:
    """(ms, "bytes" or "operations"): the least time for ``work`` =
    (bytes moved, int8 operations)."""
    t_bytes, t_ops = work[0] / HBM_BPS, work[1] / INT8_OPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def fused_work(tabs, B, twiddle_bytes):
    """A whole kernel-1 (1b) transform of B polys over limbs with tables
    ``tabs``: x in and out once, the limb's twiddle table (16 B an entry for
    the Shoup pair, 8 for the Montgomery table), both stages' m-vector and
    Pease row 0 (value, companion) pairs."""
    return sum(16 * B * t.n + twiddle_bytes * t.n + 24 * (t.n1 + t.n2) for t in tabs), 0


def stage_work(L, B, m, c, twiddle_bytes=0):
    """One butterfly stage (kernels 1, 1b, 4, 5) over an (m, c) block of B
    polys per limb: x in and y out once, the limb's m-vector and Pease row 0
    (value, companion) pairs, and a first stage's twiddle over the block."""
    return L * (16 * B * m * c + 24 * m + twiddle_bytes * m * c), 0


def digit_floor(tabs, B, *stages):
    """The TPU method's floor for the same stages (m, c), for comparison: its
    int8 digit product does 2·(nd·m)² operations per column, at 1,979 T/s."""
    ops = sum(2 * B * (t.nd * m) ** 2 * c for t in tabs for m, c in stages)
    return f"; TPU method's floor {ops / INT8_OPS * 1e6:.1f} us ({ops / 1e9:.2f} G int8 ops)"


def fused_case(cases, fntt, x, sel, fwd, mont, run, iters, tag):
    """A whole kernel-1 (1b with ``mont``) transform ``run`` of x over limbs
    ``sel`` against its plain version (the two butterfly stages in torch),
    after a one-off check against the digit-matmul plain transform (the TPU
    method's twin)."""
    import torch

    from ppqsflhe_tpu_torch.ops import mxu_ntt

    got = run()
    fn = mxu_ntt.mxu_ntt_limb if fwd else mxu_ntt.mxu_intt_limb
    digit = torch.stack([fn(x[..., k, :], fntt.tabs[i], mont) for k, i in enumerate(sel)],
                        dim=-2)
    if not torch.equal(got, digit):
        raise AssertionError(f"kernel 1{'b' if mont else ''} differs from the digit transform "
                             f"({tag})")
    B, tabs = x.numel() // (len(sel) * fntt.n), [fntt.tabs[i] for i in sel]
    counter = "mxu_ntt_mont" if mont else "mxu_ntt"
    plain = lambda: fntt.fused_plain(x, fwd, sel, mont)
    cases.check(f"{counter} ({'forward' if fwd else 'inverse'}, {tag})", counter, SRC_NTT,
                K1B if mont else K1, got, plain(), run, plain, iters,
                fused_work(tabs, B, 8 if mont else 16),
                note=digit_floor(tabs, B, (fntt.n1, fntt.n2), (fntt.n2, fntt.n1)))


def fused_stage_checks(cases, fntt, x, tag):
    """Kernels 1 and 1b one stage at a time on x (B, L, N) over all L limbs:
    stage 1 then stage 2 of each direction and twiddle kind against their
    plain versions."""
    import torch

    from ppqsflhe_tpu_torch.ops import cuda_mxu_ntt as cm

    B, L = x.shape[:2]
    sel = list(range(L))
    st = fntt.tables.streamed
    tabs = [st.limb(i) for i in sel]
    for fwd in (True, False):
        m1, m2 = (fntt.n1, fntt.n2) if fwd else (fntt.n2, fntt.n1)
        xb = x.reshape(B, L, m1, m2)
        for mont in (False, True):
            buf, info1, info2 = st.device(x.device, sel, fwd, mont)
            y = torch.empty((B, L, m2, m1), dtype=torch.int64, device=x.device)
            z = torch.empty_like(y)
            counter = "mxu_ntt_mont" if mont else "mxu_ntt"
            name = (f"{counter} stage %d ({'forward' if fwd else 'inverse'}, m=%d, limbs {sel} x "
                    f"{B} polys, {tag})")
            k = K1B if mont else K1
            run1 = lambda: cm.ntt_stage(xb, y, buf, info1, fwd, True, mont)
            plain1 = lambda: cm.stage1_plain(xb, tabs, fwd, mont)
            cases.check(name % (1, m1), counter, SRC_NTT, k, run1().clone(), plain1(), run1,
                        plain1, 5, stage_work(L, B, m1, m2, 8 if mont else 16),
                        note=digit_floor(fntt.tabs, B, (m1, m2)))
            run2 = lambda: cm.ntt_stage(y, z, buf, info2, fwd, False, mont)
            plain2 = lambda: cm.stage2_plain(y, tabs, fwd)
            cases.check(name % (2, m2), counter, SRC_NTT, k, run2().clone(), plain2(), run2,
                        plain2, 5, stage_work(L, B, m2, m1),
                        note=digit_floor(fntt.tabs, B, (m2, m1)))


def butterfly_work(L, B, n1, n2):
    """A kernel-6 transform of B polys over L limbs: x in and out, two
    (value, companion) elementwise tables and the Pease stage tables."""
    stages = 16 * ((n1.bit_length() - 1) * n1 // 2 + (n2.bit_length() - 1) * n2 // 2)
    return L * (16 * B * n1 * n2 + 32 * n1 * n2 + stages), 0


def fourstep_pass_work(L, B, m, c, tables):
    """One kernel-6 launch over an (m, c) block of B polys per limb: x in and
    y out once, ``tables`` (m, c) (value, companion) pairs and Pease row 0."""
    return L * (16 * B * m * c + 16 * tables * m * c + 8 * m), 0


def fourstep_pass_checks(cases, bf, x, tag):
    """Kernel 6 one launch at a time on x (B, L, N) over all L limbs: pass 1
    then pass 2 of each direction against their plain versions."""
    import torch

    from ppqsflhe_tpu_torch.ops import cuda_ntt

    B, L = x.shape[:2]
    sel = list(range(L))
    for fwd in (True, False):
        m1, m2 = (bf.n1, bf.n2) if fwd else (bf.n2, bf.n1)
        xb = x.reshape(B, L, m1, m2)
        tabs, info1, info2 = bf.device(x.device, sel, fwd)
        y = torch.empty((B, L, m2, m1), dtype=torch.int64, device=x.device)
        z = torch.empty_like(y)
        name = (f"fourstep_ntt pass %d ({'forward' if fwd else 'inverse'}, m=%d, limbs {sel} x "
                f"{B} polys, {tag})")
        run1 = lambda: cuda_ntt.fourstep_pass(xb, y, tabs, info1, fwd, True)
        plain1 = lambda: bf.plain_pass(xb, fwd, True, sel)
        cases.check(name % (1, m1), "fourstep_ntt", SRC_FS, K6, run1().clone(), plain1(), run1,
                    plain1, 5, fourstep_pass_work(L, B, m1, m2, 2 if fwd else 1))
        run2 = lambda: cuda_ntt.fourstep_pass(y, z, tabs, info2, fwd, False)
        plain2 = lambda: bf.plain_pass(y, fwd, False, sel)
        cases.check(name % (2, m2), "fourstep_ntt", SRC_FS, K6, run2().clone(), plain2(), run2,
                    plain2, 5, fourstep_pass_work(L, B, m2, m1, 0 if fwd else 1))


def ext_work(B, ls, ld, n):
    return 8 * (B * n * (ls + ld) + 4 * ls + 3 * ld + 2 * ls * ld), 0


def ks_work(B, nd, lk, n):
    return 8 * n * lk * (B * nd + 2 * nd + 2 * B), 0


def sh(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def _module(name):
    import importlib

    return importlib.import_module(f"ppqsflhe_tpu_torch.{name}")


def reset_counts() -> None:
    for mod, attr, _ in COUNTERS.values():
        setattr(_module(mod), attr, 0)


def read_counts() -> dict:
    return {k: getattr(_module(mod), attr) for k, (mod, attr, _) in COUNTERS.items()}


def cuda_ms(fn, iters: int, warmup: int = 2):
    """Mean wall milliseconds per call of ``fn``, back to back (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_events(fn, iters: int = 1, symbol: str | None = None, expect: int | None = None):
    """The device activities (kernels, copies) of ``iters`` calls of ``fn``
    under torch.profiler whose name holds ``symbol`` (all when None), as
    (name, µs) pairs. A profile may lack some activities of calls that ran
    (on the H100, now and then at N ≤ 2^15; one or two of every window
    once the N=2^16 phases have run), so: with ``expect``, the first of
    three profiles that holds exactly ``expect`` activities, else the
    fullest of them; without it, the fuller of two."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best, seen = [], []
    for _ in range(3 if expect is not None else 2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and (symbol is None or symbol in e.name)]
        if expect is not None and len(evs) == expect:
            return evs
        seen.append(len(evs))
        if len(evs) > len(best):
            best = evs
    if expect is not None:
        print(f"[profiler] {symbol}: {seen} activities in three profiles, {expect} launched")
    return best


def device_ms(fn, iters: int, symbol: str | None = None, expect: int | None = None):
    """Device ms per call of the activities :func:`device_events` returns;
    None when it returns none. With ``expect``, a profile short of launches
    counts each missing one at the mean of those it holds, if it holds at
    least half of them (else None)."""
    evs = device_events(fn, iters, symbol, expect)
    if not evs or (expect is not None and 2 * len(evs) < expect):
        return None
    total = sum(us for _, us in evs) * (expect / len(evs) if expect else 1)
    return total / iters / 1e3


def show_us(ms):
    return "not measured" if ms is None else f"{ms * 1e3:.1f} us"


def rand_residues(moduli, shape, n, gen, device):
    """Uniform residues int64[*shape, len(moduli), n] below each modulus."""
    import torch

    return torch.stack([torch.randint(0, q, tuple(shape) + (n,), generator=gen,
                                      dtype=torch.int64) for q in moduli],
                       dim=len(shape)).to(device)


class KernelCases:
    """The rows of the JSON ``kernels`` line: each case holds a kernel to its
    plain version (bit-equal) and times both."""

    def __init__(self, card: str):
        self.card = card
        self.rows = []

    def check(self, name, counter, source, replaces, got, want, fn, plain_fn, iters, work,
              library_ms=None, note=""):
        """``work``: (bytes, int8 operations) of one call, for its bound;
        ``library_ms``: the time of one PyTorch call for the same function;
        ``note``: appended to the printed line."""
        import torch

        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(f"{name}: kernel differs from plain version in {bad} residues")
        err = (got - want).abs().max().item()
        symbol = COUNTERS[counter][2]
        before = read_counts()[counter]
        fn()
        per_call = read_counts()[counter] - before
        wall, plain_wall = cuda_ms(fn, iters), cuda_ms(plain_fn, max(2, iters // 5))
        dev = device_ms(fn, iters, symbol, expect=per_call * iters)
        plain_dev = device_ms(plain_fn, max(2, iters // 5))
        if dev is None or plain_dev is None:
            print(f"[kernel] {name}: no profile held half the launches; device time not measured")
        timing = "profiler" if dev is not None and plain_dev is not None else "cuda_events"
        bound_ms, bound_by = bound(work)
        print(f"[kernel] {name}: bit-equal to plain; device time per call: kernel "
              f"{show_us(dev)} ({per_call:g} launches of {symbol}), plain {show_us(plain_dev)}; "
              f"wall mean per "
              f"call: kernel {wall * 1e3:.1f} us, plain {plain_wall * 1e3:.1f} us; bound "
              f"{bound_ms * 1e3:.2f} us by {bound_by} ({work[0] / 1e6:.2f} MB, "
              f"{work[1] / 1e9:.2f} G int8 ops){note} ({self.card})")
        self.rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, counter=counter,
            max_abs_err=err, ms=dev if timing == "profiler" else wall,
            plain_ms=plain_dev if timing == "profiler" else plain_wall,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            timing=timing, wall_ms=wall, plain_wall_ms=plain_wall))

    def take_launches(self, counts: dict) -> list:
        """Give every row the main path's launch count of its kernel."""
        rows = [dict(r, launches=counts[r["counter"]]) for r in self.rows]
        for r in rows:
            del r["counter"]
        return rows


# ---------------------------------------------------------------------------
# Path 1: the server round at N=2^14
# ---------------------------------------------------------------------------

def round_kernel_checks(cases, sch, rk_mont, gen, device):
    """Each kernel against its plain version at the round's shapes."""
    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.ckks.eval import _ks_decomp_consts
    from ppqsflhe_tpu_torch.ops import cuda_ext
    from ppqsflhe_tpu_torch.ops.cuda_ks import ks_inner_product, ks_inner_product_plain

    ctx, n = sch.ctx, sch.params.n
    mq = ctx.moduli_qp
    L, K = sch.params.num_q, sch.params.num_p

    # kernel 1: the 2-limb transforms of the lazy key switch (q0: nd=9,
    # q1: nd=6) over both components of 27 ciphertexts
    idx = (0, 1)
    x = rand_residues([mq[i] for i in idx], (2 * N_CTS,), n, gen, device)
    fused_case(cases, ctx.fntt, x, idx, True, False, lambda: ctx.ntt(x, idx), 20,
               f"2 limbs x {2 * N_CTS} polys, N=2^14")
    got = ctx.ntt(x, idx)
    back = ctx.intt(got, idx)
    if not (torch.equal(back, ctx.fntt.fused_plain(got, False, idx)) and torch.equal(back, x)):
        raise AssertionError("mxu_ntt inverse differs from plain version or input")

    # kernel 2: every base extension the two schedules run — at each PRE
    # level l ∈ {3, 2, 1}, each digit group's decompose+extend (its constant
    # folded in, over the 27 c1 polys) and the ModDown P → Q_l (no constant,
    # over both components of the 27 products)
    for l in (L, L - 1, 1):
        idx_ext = ctx.q_idx(l) + ctx.p_idx()
        groups, consts = _ks_decomp_consts(ctx, l)
        todo = [(g, tuple(i for i in idx_ext if i not in g), pre, (N_CTS,))
                for g, pre in zip(groups, consts)]
        todo.append((ctx.p_idx(), ctx.q_idx(l), None, (2, N_CTS)))
        for src, dst, pre, lead in todo:
            ext = ctx.extender(src, dst)
            xe = rand_residues([mq[i] for i in src], lead, n, gen, device)
            tag = "pre" if pre is not None else "ModDown"
            cases.check(f"base_extend (l={l}, {len(src)}->{len(dst)} limbs, {tag}, "
                        f"{'x'.join(map(str, lead))} polys, N=2^14)", "base_extend", SRC_EXT, K2,
                        cuda_ext.fused_extend(xe, ext, pre), ext.extend(xe, pre),
                        lambda: cuda_ext.fused_extend(xe, ext, pre),
                        lambda: ext.extend(xe, pre), 50,
                        ext_work(int(np.prod(lead)), len(src), len(dst), n))

    # kernel 3: the full-level inner product, nd=2 digits over LK=5 limbs
    limbs = tuple(range(L + K))
    nd = len(ctx.digit_groups)
    q, qinv, _ = ctx.limb_consts(limbs, device)
    sel = ctx.consts(("limb_map", limbs), lambda: limbs, device)
    dig = rand_residues(mq, (N_CTS, nd), n, gen, device)
    args = (dig, rk_mont.data, sel, q, qinv)
    cases.check(f"ks_inner_product (nd={nd}, LK={len(limbs)}, {N_CTS} polys, N=2^14)",
                "ks_inner_product", SRC_KS, K3,
                ks_inner_product(*args), ks_inner_product_plain(*args),
                lambda: ks_inner_product(*args), lambda: ks_inner_product_plain(*args), 50,
                ks_work(N_CTS, nd, len(limbs), n))
    ks_one_digit_checks(cases, sch, rk_mont, gen, device)
    ext_generic_checks(cases, n, gen, device)
    torch.cuda.synchronize()


def ks_one_digit_checks(cases, sch, rk_mont, gen, device):
    """Kernel 3 at the lazy-4 schedule's one-digit shapes — nd=1 over the 27
    c1 polys at l=2 (LK=4) and l=1 (LK=3) — against its plain version, and
    the ``[A/B ks nd=1]`` line: kernel against plain, device and wall (the
    two cases' own timings)."""
    from ppqsflhe_tpu_torch.ops.cuda_ks import ks_inner_product, ks_inner_product_plain

    ctx, n = sch.ctx, sch.params.n
    tag = f"N=2^{n.bit_length() - 1}"
    parts = []
    for l in (2, 1):
        limbs = tuple(ctx.q_idx(l)) + ctx.p_idx()
        q, qinv, _ = ctx.limb_consts(limbs, device)
        sel = ctx.consts(("limb_map", limbs), lambda: limbs, device)
        dig = rand_residues([ctx.moduli_qp[i] for i in limbs], (N_CTS, 1), n, gen, device)
        args = (dig, rk_mont.data, sel, q, qinv)
        run, plain = lambda: ks_inner_product(*args), lambda: ks_inner_product_plain(*args)
        cases.check(f"ks_inner_product (nd=1, LK={len(limbs)}, {N_CTS} polys, l={l}, {tag})",
                    "ks_inner_product", SRC_KS, K3, run(), plain(), run, plain, 20,
                    ks_work(N_CTS, 1, len(limbs), n))
        r = cases.rows[-1]
        parts.append(f"l={l} (LK={len(limbs)}): kernel 3 {show_us(r['ms'])}, plain "
                     f"{show_us(r['plain_ms'])} ({r['timing']}); wall "
                     f"{r['wall_ms'] * 1e3:.1f} / {r['plain_wall_ms'] * 1e3:.1f} us")
    print(f"[A/B ks nd=1] {tag}, {N_CTS} polys, bit-equal: " + "; ".join(parts)
          + f" ({cases.card})")


def ext_generic_checks(cases, n, gen, device):
    """Kernel 2's generic instance (shapes without an unrolled one: 4 -> 2
    limbs, and 3 -> 10 in two launches, 3 -> 8 generic then 3 -> 2) on 50-bit
    moduli, 27 polys."""
    from ppqsflhe_tpu_torch.core import primes
    from ppqsflhe_tpu_torch.core.rns import BaseExtender
    from ppqsflhe_tpu_torch.ops import cuda_ext

    moduli = primes.prime_chain(50, 13, 2 * n)
    pre = [primes.mod_inverse(7 + i, q) for i, q in enumerate(moduli[:4])]
    for ls, ld in ((4, 2), (3, 10)):
        ext = BaseExtender(moduli[:ls], moduli[ls:ls + ld])
        xe = rand_residues(moduli[:ls], (N_CTS,), n, gen, device)
        cases.check(f"base_extend (generic, {ls}->{ld} limbs, pre, {N_CTS} polys, "
                    f"N=2^{n.bit_length() - 1})", "base_extend", SRC_EXT, K2,
                    cuda_ext.fused_extend(xe, ext, pre[:ls]), ext.extend(xe, pre[:ls]),
                    lambda: cuda_ext.fused_extend(xe, ext, pre[:ls]),
                    lambda: ext.extend(xe, pre[:ls]), 20, ext_work(N_CTS, ls, ld, n))


def max_err(sch, sk, cts, want):
    """Max |decrypt - want| over every ciphertext of the batch and slot."""
    from ppqsflhe_tpu_torch.ckks.types import Ciphertext

    err = 0.0
    for i in range(cts.data.shape[0]):
        got = sch.decrypt(sk, Ciphertext(cts.data[i], cts.scale))
        err = max(err, float(abs(got - want[i]).max()))
    return err


def round_world(n, device, slots=0):
    """Seeded keys, rekeys (Montgomery form) and 2 × N_CTS encryptions of
    uniform(-1, 1) payloads for the server round on the
    ``CkksParams.generate(n, mult_depth=2, scale_bits=40, dnum=2)`` chain."""
    import types

    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.ckks import eval as ev
    from ppqsflhe_tpu_torch.ckks.params import CkksParams
    from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme

    t0 = time.perf_counter()
    params = CkksParams.generate(n=n, mult_depth=2, scale_bits=40, dnum=2, slots=slots)
    sch = CkksScheme(params, device=device)
    t_ctx = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(SEED)
    sk1, pk1 = sch.keygen(gen)
    sk2, pk2 = sch.keygen(gen)
    rk12 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk1, pk2, gen))
    rk21 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk2, pk1, gen))
    rng = np.random.default_rng(SEED)
    slots = sch.encoder.slots
    v1 = [rng.uniform(-1, 1, slots) for _ in range(N_CTS)]
    v2 = [rng.uniform(-1, 1, slots) for _ in range(N_CTS)]
    ct1 = sch.encrypt_values(pk1, v1, gen)
    ct2 = sch.encrypt_values(pk2, v2, gen)
    torch.cuda.synchronize()
    print(f"[setup] N={n}, Q={[q.bit_length() for q in params.q_moduli]} bits, "
          f"P={[p.bit_length() for p in params.p_moduli]} bits, dnum={params.dnum}, "
          f"{slots} slots; context {t_ctx:.1f} s, then keys, rekeys and 2x{N_CTS} "
          f"encryptions in {time.perf_counter() - t0 - t_ctx:.1f} s")
    return types.SimpleNamespace(sch=sch, gen=gen, sk1=sk1, sk2=sk2, rk12=rk12, rk21=rk21,
                                 ct1=ct1, ct2=ct2, want=(np.array(v1) + np.array(v2)) / 2)


def drive_round(tag, sch, w, need, absent=()):
    """The main path: one round per schedule with fresh launch counters.
    Requires the kernels ``need[lazy]`` to have launched and ``absent`` not
    to have, checks the decrypted outputs against the plaintext mean, and
    returns (outputs by schedule, launch counts of both schedules)."""
    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.fl.api import server_round

    reset_counts()
    outs, per_sched = {}, {}
    for lazy in (4, 0):
        before = read_counts()
        outs[lazy] = server_round(sch, w.ct1, w.ct2, w.rk12, w.rk21, lazy)
        torch.cuda.synchronize()
        per_sched[lazy] = {k: v - before[k] for k, v in read_counts().items()}
    launches = read_counts()
    for lazy in (4, 0):
        print(f"[{tag} lazy={lazy}] kernel launches: "
              f"{ {k: v for k, v in per_sched[lazy].items() if v} }")
        missing = [k for k in need[lazy] if per_sched[lazy][k] == 0]
        if missing:
            raise AssertionError(f"{tag}: schedule lazy={lazy} never launched {missing}")
    wrong = [k for k in absent if launches[k]]
    if wrong:
        raise AssertionError(f"{tag}: launched {wrong}, which this configuration must not run")
    for lazy in (4, 0):
        avg, back = outs[lazy]
        e2 = max_err(sch, w.sk2, avg, w.want)
        e1 = max_err(sch, w.sk1, back, w.want)
        print(f"[{tag} lazy={lazy}] decrypt max err: average under sk2 {e2:.3e}, "
              f"re-encrypted under sk1 {e1:.3e} (gate {ERR_GATE}); output "
              f"{tuple(back.data.shape)} at {back.nlimbs} limb(s)")
        if not (np.isfinite(e1) and np.isfinite(e2) and max(e1, e2) < ERR_GATE):
            raise AssertionError(f"{tag} lazy={lazy}: decrypt error {max(e1, e2)} over the gate")
    return outs, launches


def host_ms(fn):
    """Median host milliseconds to enqueue one call of ``fn`` (the host
    clock around the call, the device drained before each)."""
    import torch

    times = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def time_round(tag, sch, w, card, profile_on):
    """ms/round per schedule (median of per-round CUDA-event times), the
    host's enqueue time, and the device time by kernel of one round."""
    from ppqsflhe_tpu_torch.fl.api import server_round

    for lazy in (4, 0):
        run = lambda: server_round(sch, w.ct1, w.ct2, w.rk12, w.rk21, lazy)
        times = median_ms(run, 3)
        print(f"[timing {tag} lazy={lazy}] server round {statistics.median(times):.3f} ms/round "
              f"(median of {len(times)}, min {min(times):.3f}, max {max(times):.3f}; host "
              f"enqueue {host_ms(run):.3f} ms; 2x{N_CTS} ciphertexts, N={sch.params.n}; {card})")
        busy_line(f"{tag} lazy={lazy}", run, statistics.median(times))
        if profile_on:
            profile_table(f"{tag} lazy={lazy}", run)


def round_phase(card, device, profile_on):
    """The server round: set-up, kernel checks, main path, decrypt, timing.
    Returns the kernels' JSON rows, the round's world and its outputs."""
    w = round_world(N_ROUND, device)
    cases = KernelCases(card)
    round_kernel_checks(cases, w.sch, w.rk12, w.gen, device)
    need = ("mxu_ntt", "base_extend", "ks_inner_product")
    outs, launches = drive_round("round", w.sch, w, {4: need, 0: need})
    time_round("round", w.sch, w, card, profile_on)
    return cases.take_launches(launches), w, outs


def median_ms(fn, warmup: int):
    """Per-call CUDA-event milliseconds of ROUNDS calls after ``warmup``."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(ROUNDS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return times


def device_events_once(fn):
    """The device activities of one call of ``fn`` from one CUDA-only
    profile, read from the raw kineto events: a training epoch launches
    ~100,000 kernels, and building the profiler's event tree for them took
    25 s (70 times the raw read)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name(), e.duration_ns() / 1e3) for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def busy_line(tag, fn, wall_ms, once=False):
    """Device time by kernel for one call of ``fn`` against its wall time
    (``once``: from :func:`device_events_once`)."""
    evs = device_events_once(fn) if once else device_events(fn)
    if not evs:
        print(f"[busy {tag}] not measured: the profiler saw no device activity")
        return
    by = {k: 0.0 for k in COUNTERS}
    other = 0.0
    for name, us in evs:
        key = next((k for k, (_, _, sym) in COUNTERS.items() if sym in name), None)
        if key is None:
            other += us
        else:
            by[key] += us
    busy = sum(by.values()) + other
    parts = [f"{k} {v / 1e3:.3f}" for k, v in by.items() if v] + [f"other ops {other / 1e3:.3f} ms"]
    print(f"[busy {tag}] device {busy / 1e3:.3f} ms of {wall_ms:.3f} ms wall "
          f"(idle {max(0.0, 1 - busy / 1e3 / wall_ms):.1%}): {', '.join(parts)}, {len(evs)} "
          f"device activities")


def profile_table(tag, fn):
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    print(f"[profile {tag}]")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))


# ---------------------------------------------------------------------------
# Path 2: hoisted Galois rotations at N=2^15
# ---------------------------------------------------------------------------

def rotation_kernel_checks(cases, sch, rot_keys, gen, device):
    """Kernels 4 and 5 (and 1, 2, 3) against their plain versions at the
    shapes one full-level rotation gives them."""
    import torch

    from ppqsflhe_tpu_torch.ckks.eval import _ks_decomp_consts
    from ppqsflhe_tpu_torch.ops import cuda_ext, cuda_mxu_ntt, streamed_ntt
    from ppqsflhe_tpu_torch.ops.cuda_ks import ks_inner_product, ks_inner_product_plain

    ctx, n = sch.ctx, sch.params.n
    fntt = ctx.fntt
    mq = ctx.moduli_qp
    L, K = sch.params.num_q, sch.params.num_p
    nd9 = [i for i, t in enumerate(fntt.tabs) if cuda_mxu_ntt.route(n, t.nd) == "big"]
    nd6 = [i for i, t in enumerate(fntt.tabs) if cuda_mxu_ntt.route(n, t.nd) == "fused"]
    print(f"[route N={n}] big (kernels 4+5): limbs {nd9}; fused (kernel 1): limbs {nd6}")
    if not nd9 or not nd6:
        raise AssertionError("the rotation chain must route limbs both ways at N=2^15")

    # kernels 4 and 5: the nd=9 limbs of the key switch's extended digit
    # (q0, p0, p1, forward, one poly) and of ModDown's iNTT (p0, p1 over both
    # components), each stage against its plain version (stage A also on
    # half the columns, with lazy inputs < 4q), then the whole transform
    # through the big route against kernel 1 and the plain version
    st = fntt.big.streamed
    for sel, lead, fwd in (([0] + list(ctx.p_idx()), (1,), True), (list(ctx.p_idx()), (2,), False)):
        sel = [i for i in sel if i in nd9]
        tag = f"{'forward' if fwd else 'inverse'}, limbs {sel} x {lead[0]} poly(s), N=2^15"
        m1, m2 = (fntt.n1, fntt.n2) if fwd else (fntt.n2, fntt.n1)
        x = rand_residues([mq[i] for i in sel], lead, n, gen, device).reshape(
            lead[0], len(sel), m1, m2)
        buf, info_a, info_b = st.device(device, sel, fwd)
        tabs = [st.limb(i) for i in sel]
        ya = torch.empty_like(x)
        run_a = lambda: streamed_ntt.stage_a(x, ya, buf, info_a, fwd, m2)
        plain_a = lambda: streamed_ntt.stage_a_plain(x, tabs, fwd)
        cases.check(f"streamed_stage_a ({tag})", "streamed_stage_a", SRC_STREAMED, K4,
                    run_a().clone(), plain_a(), run_a, plain_a, 20,
                    stage_work(len(sel), lead[0], m1, m2, 16),
                    note=digit_floor([fntt.tabs[i] for i in sel], lead[0], (m1, m2)))
        zb = torch.empty((lead[0], len(sel), m2, m1), dtype=torch.int64, device=device)
        run_b = lambda: streamed_ntt.stage_b(ya, zb, buf, info_b, fwd)
        plain_b = lambda: streamed_ntt.stage_b_plain(ya, tabs, fwd)
        cases.check(f"streamed_stage_b ({tag})", "streamed_stage_b", SRC_STREAMED, K5,
                    run_b().clone(), plain_b(), run_b, plain_b, 20,
                    stage_work(len(sel), lead[0], m2, m1),
                    note=digit_floor([fntt.tabs[i] for i in sel], lead[0], (m2, m1)))
        # stage A on one half of the columns, reading its slice of the table
        h = m2 // 2
        qs = torch.tensor([mq[i] for i in sel], device=device)[None, :, None, None]
        xh = (x[..., h:] + 3 * qs).contiguous()
        got = streamed_ntt.stage_a(xh, torch.empty_like(xh), buf, info_a, fwd, m2, h)
        if not torch.equal(got, streamed_ntt.stage_a_plain(xh, tabs, fwd, h)):
            raise AssertionError(f"streamed_stage_a on columns [{h}, {m2}) differs ({tag})")
        # the whole transform: big route = kernel 1's fused launches = plain
        xf = x.reshape(lead + (len(sel), n))
        run = fntt.ntt if fwd else fntt.intt
        big, fused = run(xf, sel), fntt.fused(xf, fwd, sel)
        plain = fntt.fused(xf.cpu(), fwd, sel).to(device)
        if not (torch.equal(big, fused) and torch.equal(big, plain)):
            raise AssertionError(f"big route differs from kernel 1 or the plain version ({tag})")
        t_big = device_ms(lambda: run(xf, sel), 20)
        t_fused = device_ms(lambda: fntt.fused(xf, fwd, sel), 20)
        w_big, w_fused = cuda_ms(lambda: run(xf, sel), 20), cuda_ms(
            lambda: fntt.fused(xf, fwd, sel), 20)
        show = lambda v: "not measured" if v is None else f"{v * 1e3:.1f} us"
        print(f"[route nd=9] {tag}: bit-equal (big = kernel 1 = plain); device time per "
              f"transform: big route (kernels 4+5) {show(t_big)}, fused route (kernel 1) "
              f"{show(t_fused)}; wall mean {w_big * 1e3:.1f} / {w_fused * 1e3:.1f} us "
              f"({cases.card})")

    # kernel 1: the nd=6 limbs of ModDown's NTT back to Q (q1, q2, both
    # components), forward and back
    idx = tuple(i for i in ctx.q_idx(L) if i in nd6)
    x = rand_residues([mq[i] for i in idx], (2,), n, gen, device)
    fused_case(cases, fntt, x, idx, True, False, lambda: ctx.ntt(x, idx), 20,
               f"limbs {list(idx)} x 2 polys, N=2^15")
    if not torch.equal(ctx.intt(ctx.ntt(x, idx), idx), x):
        raise AssertionError("mxu_ntt inverse at N=2^15 does not give the input back")

    # kernel 2: the full-level key switch's three extensions — each digit
    # group (its constant folded in, one poly) and ModDown P → Q (2 polys)
    idx_ext = ctx.q_idx(L) + ctx.p_idx()
    groups, consts = _ks_decomp_consts(ctx, L)
    todo = [(g, tuple(i for i in idx_ext if i not in g), pre, (1,))
            for g, pre in zip(groups, consts)]
    todo.append((ctx.p_idx(), ctx.q_idx(L), None, (2,)))
    for src, dst, pre, lead in todo:
        ext = ctx.extender(src, dst)
        xe = rand_residues([mq[i] for i in src], lead, n, gen, device)
        tag = "pre" if pre is not None else "ModDown"
        cases.check(f"base_extend ({len(src)}->{len(dst)} limbs, {tag}, {lead[0]} poly(s), "
                    f"N=2^15)", "base_extend", SRC_EXT, K2,
                    cuda_ext.fused_extend(xe, ext, pre), ext.extend(xe, pre),
                    lambda: cuda_ext.fused_extend(xe, ext, pre), lambda: ext.extend(xe, pre), 50,
                    ext_work(lead[0], len(src), len(dst), n))

    # kernel 3: one rotation's inner product, nd=2 digits over LK=5 limbs
    limbs = tuple(range(L + K))
    nd = len(ctx.digit_groups)
    q, qinv, _ = ctx.limb_consts(limbs, device)
    sel = ctx.consts(("limb_map", limbs), lambda: limbs, device)
    dig = rand_residues(mq, (1, nd), n, gen, device)
    args = (dig, rot_keys[ROTS[0]].data, sel, q, qinv)
    cases.check(f"ks_inner_product (nd={nd}, LK={len(limbs)}, 1 poly, N=2^15)",
                "ks_inner_product", SRC_KS, K3,
                ks_inner_product(*args), ks_inner_product_plain(*args),
                lambda: ks_inner_product(*args), lambda: ks_inner_product_plain(*args), 50,
                ks_work(1, nd, len(limbs), n))
    torch.cuda.synchronize()


def rotation_phase(card, device, profile_on):
    """Rotations at N=2^15: set-up, kernel checks, main path, decrypt,
    timing. Returns the kernels' JSON rows."""
    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.ckks import eval as ev
    from ppqsflhe_tpu_torch.ckks.params import CkksParams
    from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme

    t0 = time.perf_counter()
    params = CkksParams.generate(n=N_ROT, mult_depth=2, scale_bits=40, dnum=2)
    sch = CkksScheme(params, device=device)
    t_ctx = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(SEED)
    sk, pk = sch.keygen(gen)
    slots = sch.encoder.slots
    ip_rots = [1 << i for i in range(int(np.log2(slots)))]
    # long-lived keys go to Montgomery form once (bench_rotations.py:155-157)
    rot_keys = {r: ev.ksk_to_mont(sch.ctx, k) for r, k in
                sch.rotation_key_gen(sk, sorted(set(ROTS) | set(ip_rots)), gen).items()}
    relin = ev.ksk_to_mont(sch.ctx, sch.relin_key_gen(sk, gen))
    v = np.linspace(-1, 1, slots)
    ct = sch.encrypt_values(pk, v, gen)
    rng = np.random.default_rng(SEED)
    u1, u2 = rng.uniform(-1, 1, slots) * 0.1, rng.uniform(-1, 1, slots) * 0.1
    cu1, cu2 = sch.encrypt_values(pk, u1, gen), sch.encrypt_values(pk, u2, gen)
    torch.cuda.synchronize()
    print(f"[setup] N={N_ROT}, Q={[q.bit_length() for q in params.q_moduli]} bits, "
          f"P={[p.bit_length() for p in params.p_moduli]} bits, dnum={params.dnum}; context "
          f"{t_ctx:.1f} s, then keys, {len(rot_keys)} rotation keys, relin key and 3 "
          f"encryptions in {time.perf_counter() - t0 - t_ctx:.1f} s")

    cases = KernelCases(card)
    rotation_kernel_checks(cases, sch, rot_keys, gen, device)

    # the main path: R plain rotations, one hoisted pass, one rotation sum
    plain = lambda: [sch.rotate(ct, r, rot_keys) for r in ROTS]
    hoisted = lambda: sch.rotate_hoisted(ct, ROTS, rot_keys)
    rot_sum = lambda: sch.rotate_sum_hoisted(ct, ROTS, rot_keys)
    reset_counts()
    outs_p, outs_h, out_s = plain(), hoisted(), rot_sum()
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"[rotations] kernel launches (R={len(ROTS)} plain + hoisted + rotation sum): "
          f"{launches}")
    missing = [k for k in ("mxu_ntt", "streamed_stage_a", "streamed_stage_b", "base_extend",
                           "ks_inner_product") if launches[k] == 0]
    if missing:
        raise AssertionError(f"the rotation path never launched {missing}")

    err_h = max(float(np.abs(sch.decrypt(sk, o) - np.roll(v, -r)).max())
                for r, o in zip(ROTS, outs_h))
    same = all(torch.equal(p.data, h.data) for p, h in zip(outs_p, outs_h))
    err_s = float(np.abs(sch.decrypt(sk, out_s) - sum(np.roll(v, -r) for r in ROTS)).max())
    ip = sch.inner_product(cu1, cu2, relin, rot_keys)
    err_ip = float(np.abs(sch.decrypt(sk, ip) - np.dot(u1, u2)).max())
    print(f"[rotations] hoisted decrypt max err {err_h:.3e} (gate {ERR_GATE}); plain "
          f"bit-equal to hoisted: {same}; rotation sum err {err_s:.3e} (gate {SUM_GATE}); "
          f"inner product of {slots} slots err {err_ip:.3e} (gate {ERR_GATE})")
    if not (np.isfinite(err_h) and err_h < ERR_GATE and same and np.isfinite(err_s)
            and err_s < SUM_GATE and np.isfinite(err_ip) and err_ip < ERR_GATE):
        raise AssertionError("a rotation check failed")

    us = {}
    for name, fn in (("plain", plain), ("hoisted", hoisted), ("rot_sum", rot_sum)):
        times = median_ms(fn, 3)
        us[name] = statistics.median(times) * 1e3 / len(ROTS)
        print(f"[timing rotations] {name}: {us[name]:.1f} us/rotation (median of {len(times)} "
              f"passes of R={len(ROTS)}, min {min(times) * 1e3 / len(ROTS):.1f}, max "
              f"{max(times) * 1e3 / len(ROTS):.1f}; N={N_ROT}; {card})")
        busy_line(f"rotations {name}", fn, statistics.median(times))
    print(f"[timing rotations] hoisting speed-up {us['plain'] / us['hoisted']:.2f}x, "
          f"rotation sum speed-up {us['plain'] / us['rot_sum']:.2f}x over plain rotations")
    if profile_on:
        profile_table("rotations hoisted", hoisted)
    return cases.take_launches(launches)


# ---------------------------------------------------------------------------
# Path 3: the NTT north star at N=2^14 and N=2^16, both implementations
# ---------------------------------------------------------------------------

def ab_line(tag, fa, fb, names, card):
    """Device and wall time per call of two functions that must agree."""
    import torch

    a, b = fa(), fb()
    if not torch.equal(a, b):
        raise AssertionError(f"[A/B] {tag}: {names[0]} and {names[1]} differ")
    dev = [device_ms(f, 10) for f in (fa, fb)]
    wall = [cuda_ms(f, 10) for f in (fa, fb)]
    print(f"[A/B] {tag}: bit-equal; device time per call: {names[0]} {show_us(dev[0])}, "
          f"{names[1]} {show_us(dev[1])}; wall mean {wall[0] * 1e3:.1f} / "
          f"{wall[1] * 1e3:.1f} us ({card})")


def ntt_chain(run, x, steps):
    """``steps`` transforms, each output the next input."""
    for _ in range(steps):
        x = run(x)
    return x


def ntt_kernel_checks(cases, n, impls, x, card):
    """Kernel 6 (and 1b at 2^16) against the plain versions on the phase's
    inputs, with a limb subset; kernels 1 and 1b stage by stage and kernel 6
    pass by pass on every limb (m = 128 at 2^14, 256 at 2^16); the A/B
    lines."""
    from ppqsflhe_tpu_torch.ops.cuda_mxu_ntt import route

    mx, bf = impls["digit-matmul"], impls["butterfly"]
    B, L = x.shape[0], x.shape[1]
    tag = f"N=2^{n.bit_length() - 1}"
    for fwd in (True, False):
        for sel in (list(range(L)), [2, 0]):
            xs = x[:, sel].contiguous()
            run = lambda: (bf.ntt if fwd else bf.intt)(xs, sel)
            plain = lambda: bf.plain(xs, fwd, sel)
            cases.check(f"fourstep_ntt ({'forward' if fwd else 'inverse'}, limbs {sel} x {B} "
                        f"polys, {tag})", "fourstep_ntt", SRC_FS, K6, run(), plain(), run, plain,
                        10, butterfly_work(len(sel), B, bf.n1, bf.n2))
    mont = [i for i, t in enumerate(mx.tabs) if route(n, t.nd) == "fused_mont"]
    if n == N_BIG:
        if not mont:
            raise AssertionError("no limb of the N=2^16 chain routes to kernel 1b")
        xs = x[:, mont].contiguous()
        for fwd in (True, False):
            run = lambda: mx.fused(xs, fwd, mont, mont=True)
            fused_case(cases, mx, xs, mont, fwd, True, run, 10,
                       f"limbs {mont} x {B} polys, {tag}")
            ab_line(f"nd=6 {'forward' if fwd else 'inverse'}, limbs {mont} x {B} polys, {tag}",
                    run, lambda: mx.fused(xs, fwd, mont), ("kernel 1b (Montgomery twiddle)",
                                                           "kernel 1 (Shoup twiddle)"), card)
    fused_stage_checks(cases, mx, x, tag)
    fourstep_pass_checks(cases, bf, x, tag)
    for fwd in (True, False):
        name = "ntt" if fwd else "intt"
        ab_line(f"{name}, limbs 0-{L - 1} x {B} polys, {tag}",
                lambda: getattr(bf, name)(x), lambda: getattr(mx, name)(x),
                ("butterfly (kernel 6)", "digit-matmul route"), card)


def ntt_phase(card, device):
    """bench_kernels.py's NTT loop through the port's four-step runner, in
    both implementations at both sizes: kernel checks, then the chained
    transforms as the main path (forward then inverse), bit-equal across
    implementations, to the plain version, and back to the input; µs per
    limb-NTT and limb-NTT/s."""
    import torch

    from ppqsflhe_tpu_torch.core import primes
    from ppqsflhe_tpu_torch.ops.cuda_mxu_ntt import route
    from ppqsflhe_tpu_torch.ops.cuda_ntt import BUTTERFLY, MXU, four_step_ntt

    cases = KernelCases(card)
    runs = []
    for n, L, B in NTT_SIZES:
        t0 = time.perf_counter()
        moduli = [primes.first_prime_down(59, 2 * n)] + primes.prime_chain(40, 3, 2 * n)
        moduli = moduli[:L]
        psis = [primes.root_of_unity(2 * n, q) for q in moduli]
        impls = {"digit-matmul": four_step_ntt(n, moduli, psis, MXU),
                 "butterfly": four_step_ntt(n, moduli, psis, BUTTERFLY)}
        gen = torch.Generator().manual_seed(SEED)
        x = rand_residues(moduli, (B,), n, gen, device)
        routes = [route(n, t.nd) for t in impls["digit-matmul"].tabs]
        print(f"[ntt N={n} L={L} B={B}] moduli {[q.bit_length() for q in moduli]} bits, "
              f"digit-matmul routes {routes}; tables {time.perf_counter() - t0:.1f} s")
        ntt_kernel_checks(cases, n, impls, x, card)
        runs.append((n, L, B, impls, x))

    reset_counts()
    launches_by_n = {}
    for n, L, B, impls, x in runs:
        before = read_counts()
        outs = {}
        for name, f in impls.items():
            y = ntt_chain(f.ntt, x, NTT_CHAIN)
            outs[name] = (y, ntt_chain(f.intt, y, NTT_CHAIN))
        torch.cuda.synchronize()
        launches_by_n[n] = {k: v - before[k] for k, v in read_counts().items()}
        (y0, z0), (y1, z1) = outs.values()
        plain = ntt_chain(lambda v: impls["butterfly"].plain(v, True, range(L)), x, NTT_CHAIN)
        if not (torch.equal(y0, y1) and torch.equal(y0, plain)):
            raise AssertionError(f"N={n}: the chained transforms differ between "
                                 f"implementations or from the plain version")
        if not (torch.equal(z0, x) and torch.equal(z1, x)):
            raise AssertionError(f"N={n}: intt(ntt(x)) != x")
        print(f"[ntt N={n} L={L} B={B}] {NTT_CHAIN} chained forward transforms bit-equal "
              f"across implementations and to the plain version; {NTT_CHAIN} inverse give the "
              f"input back; kernel launches "
              f"{ {k: v for k, v in launches_by_n[n].items() if v} }")
    need = {NTT_SIZES[0][0]: ("mxu_ntt", "fourstep_ntt"),
            N_BIG: ("mxu_ntt_mont", "streamed_stage_a", "streamed_stage_b", "fourstep_ntt")}
    for n, keys in need.items():
        missing = [k for k in keys if launches_by_n[n][k] == 0]
        if missing:
            raise AssertionError(f"the NTT loop at N={n} never launched {missing}")
    launches = read_counts()

    for n, L, B, impls, x in runs:
        for name, f in impls.items():
            for fwd in (True, False):
                start = x if fwd else f.ntt(x)
                run = lambda: ntt_chain(f.ntt if fwd else f.intt, start, NTT_CHAIN)
                count = NTT_CHAIN * B * L
                dev = device_ms(run, 1)
                wall = cuda_ms(run, 3)
                per = lambda v: None if v is None else v / count
                rate = "" if dev is None else f", {count / dev * 1e3:,.0f} limb-NTT/s"
                print(f"[timing ntt N=2^{n.bit_length() - 1} L={L} B={B}] {name} "
                      f"{'forward' if fwd else 'inverse'}: device {show_us(per(dev))}/limb-NTT"
                      f"{rate}; wall {wall / count * 1e3:.2f} us/limb-NTT "
                      f"({count / wall * 1e3:,.0f} limb-NTT/s) ({card})")
    return cases.take_launches(launches)


# ---------------------------------------------------------------------------
# Path 4: the server round at N=2^16
# ---------------------------------------------------------------------------

def round16_kernel_checks(cases, sch, rk_mont, gen, device):
    """Kernels 1b, 4, 5, 2 and 3 against their plain versions at shapes the
    N=2^16 round gives them."""
    import torch

    from ppqsflhe_tpu_torch.ckks.eval import _ks_decomp_consts
    from ppqsflhe_tpu_torch.ops import cuda_ext, cuda_mxu_ntt, streamed_ntt
    from ppqsflhe_tpu_torch.ops.cuda_ks import ks_inner_product, ks_inner_product_plain

    ctx, n = sch.ctx, sch.params.n
    fntt = ctx.fntt
    mq = ctx.moduli_qp
    L, K = sch.params.num_q, sch.params.num_p
    routes = [cuda_mxu_ntt.route(n, t.nd) for t in fntt.tabs]
    print(f"[route N={n}] {routes}")
    mont = [i for i, r in enumerate(routes) if r == "fused_mont"]
    big = [i for i, r in enumerate(routes) if r == "big"]
    if not mont or not big:
        raise AssertionError("the N=2^16 chain must route limbs to kernel 1b and to 4+5")

    # kernel 1b: ModDown's NTT back to Q at full level (q1, q2 over both
    # components) and the lazy schedule's iNTT of c1 (q1 over 27 polys)
    for sel, lead, fwd in ((mont, (2 * N_CTS,), True), (mont[:1], (N_CTS,), False)):
        x = rand_residues([mq[i] for i in sel], lead, n, gen, device)
        run = lambda: (ctx.ntt if fwd else ctx.intt)(x, sel)
        fused_case(cases, fntt, x, sel, fwd, True, run, 5,
                   f"limbs {sel} x {lead[0]} polys, N=2^16")

    # kernels 4 and 5: the extended digit's forward NTT on the 60-bit limbs
    sel = [i for i in big if i not in ctx.q_idx(1)] or big
    st = fntt.big.streamed
    tabs = [st.limb(i) for i in sel]
    xb = rand_residues([mq[i] for i in sel], (N_CTS,), n, gen, device).reshape(
        N_CTS, len(sel), fntt.n1, fntt.n2)
    buf, info_a, info_b = st.device(device, sel, True)
    ya = torch.empty_like(xb)
    run_a = lambda: streamed_ntt.stage_a(xb, ya, buf, info_a, True, fntt.n2)
    plain_a = lambda: streamed_ntt.stage_a_plain(xb, tabs, True)
    tag = f"forward, limbs {sel} x {N_CTS} polys, N=2^16"
    floor = digit_floor([fntt.tabs[i] for i in sel], N_CTS, (fntt.n1, fntt.n2))
    cases.check(f"streamed_stage_a ({tag})", "streamed_stage_a", SRC_STREAMED, K4,
                run_a().clone(), plain_a(), run_a, plain_a, 5,
                stage_work(len(sel), N_CTS, fntt.n1, fntt.n2, 16), note=floor)
    zb = torch.empty((N_CTS, len(sel), fntt.n2, fntt.n1), dtype=torch.int64, device=device)
    run_b = lambda: streamed_ntt.stage_b(ya, zb, buf, info_b, True)
    plain_b = lambda: streamed_ntt.stage_b_plain(ya, tabs, True)
    cases.check(f"streamed_stage_b ({tag})", "streamed_stage_b", SRC_STREAMED, K5,
                run_b().clone(), plain_b(), run_b, plain_b, 5,
                stage_work(len(sel), N_CTS, fntt.n2, fntt.n1), note=floor)

    # kernel 2: the full-level first digit's extension and ModDown P → Q
    idx_ext = ctx.q_idx(L) + ctx.p_idx()
    groups, consts = _ks_decomp_consts(ctx, L)
    g0 = groups[0]
    for src, dst, pre, lead in ((g0, tuple(i for i in idx_ext if i not in g0), consts[0],
                                 (N_CTS,)), (ctx.p_idx(), ctx.q_idx(L), None, (2 * N_CTS,))):
        ext = ctx.extender(src, dst)
        xe = rand_residues([mq[i] for i in src], lead, n, gen, device)
        cases.check(f"base_extend ({len(src)}->{len(dst)} limbs, "
                    f"{'pre' if pre is not None else 'ModDown'}, {lead[0]} polys, N=2^16)",
                    "base_extend", SRC_EXT, K2, cuda_ext.fused_extend(xe, ext, pre),
                    ext.extend(xe, pre), lambda: cuda_ext.fused_extend(xe, ext, pre),
                    lambda: ext.extend(xe, pre), 10, ext_work(lead[0], len(src), len(dst), n))

    # kernel 3: the full-level inner product, nd=2 digits over LK=5 limbs
    limbs = tuple(range(L + K))
    nd = len(ctx.digit_groups)
    q, qinv, _ = ctx.limb_consts(limbs, device)
    lmap = ctx.consts(("limb_map", limbs), lambda: limbs, device)
    dig = rand_residues(mq, (N_CTS, nd), n, gen, device)
    args = (dig, rk_mont.data, lmap, q, qinv)
    cases.check(f"ks_inner_product (nd={nd}, LK={len(limbs)}, {N_CTS} polys, N=2^16)",
                "ks_inner_product", SRC_KS, K3, ks_inner_product(*args),
                ks_inner_product_plain(*args), lambda: ks_inner_product(*args),
                lambda: ks_inner_product_plain(*args), 10, ks_work(N_CTS, nd, len(limbs), n))
    ks_one_digit_checks(cases, sch, rk_mont, gen, device)
    torch.cuda.synchronize()


def butterfly_tables_mib(fntt, device) -> tuple:
    """(limbs, MiB) of the chain's butterfly tables on ``device``, one buffer
    for kernels 1, 1b, 4 and 5: the limbs uploaded so far and its size."""
    d = fntt.tables.streamed._dev.get(str(device))
    if d is None:
        return [], 0.0
    return sorted(d["limbs"]), d["tabs"].nbytes / 2 ** 20


def round16_route_check(sch, gen, device, card):
    """The big route's whole transform on the 60-bit limbs, forward and
    inverse over N_CTS polys, bit-equal to kernel 6's transform and kernel
    1b's, with the device time of all three."""
    import torch

    from ppqsflhe_tpu_torch.ops.cuda_mxu_ntt import route
    from ppqsflhe_tpu_torch.ops.cuda_ntt import CudaFourStepNtt

    ctx, n = sch.ctx, sch.params.n
    fntt, mq = ctx.fntt, ctx.moduli_qp
    big = [i for i, t in enumerate(fntt.tabs) if route(n, t.nd) == "big"]
    bf = CudaFourStepNtt(n, [mq[i] for i in big], [fntt.tabs[i].psi for i in big])
    x = rand_residues([mq[i] for i in big], (N_CTS,), n, gen, device)
    for fwd in (True, False):
        name = "ntt" if fwd else "intt"
        runs = {"big route (kernels 4+5)": lambda: getattr(fntt, name)(x, big),
                "kernel 6": lambda: getattr(bf, name)(x),
                "kernel 1b": lambda: fntt.fused(x, fwd, big, mont=True)}
        outs = [f() for f in runs.values()]
        if not all(torch.equal(outs[0], o) for o in outs[1:]):
            raise AssertionError(f"N=2^16 {name}: the big route, kernel 6 and kernel 1b differ")
        dev = [device_ms(f, 10) for f in runs.values()]
        wall = [cuda_ms(f, 10) for f in runs.values()]
        print(f"[route N=2^16] {'forward' if fwd else 'inverse'}, limbs {big} x {N_CTS} polys: "
              f"bit-equal (big route = kernel 6 = kernel 1b); device time per transform: "
              + ", ".join(f"{k} {show_us(d)}" for k, d in zip(runs, dev))
              + f"; wall mean {' / '.join(f'{v * 1e3:.1f}' for v in wall)} us ({card})")


def round16_phase(card, device, profile_on):
    """The server round at N=2^16 (8192 slots): set-up, kernel checks, main
    path in both schedules, decrypt, ms/round, the context's device memory,
    then the big route against kernels 6 and 1b."""
    import torch

    from ppqsflhe_tpu_torch.ops.cuda_mxu_ntt import route

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    w = round_world(N_BIG, device, slots=SLOTS)
    cases = KernelCases(card)
    round16_kernel_checks(cases, w.sch, w.rk12, w.gen, device)
    need = ("mxu_ntt_mont", "streamed_stage_a", "streamed_stage_b", "base_extend",
            "ks_inner_product")
    _, launches = drive_round("round N=2^16", w.sch, w, {4: need, 0: need})
    time_round("round N=2^16", w.sch, w, card, profile_on)
    mib = lambda v: (v - base) / 2 ** 20
    fntt = w.sch.ctx.fntt
    limbs, tables = butterfly_tables_mib(fntt, device)
    per_limb = tables / len(limbs)
    fused = [i for i in limbs if route(N_BIG, fntt.tabs[i].nd) != "big"]
    print(f"[memory N=2^16] after the round: {mib(torch.cuda.memory_allocated()):.1f} MiB "
          f"allocated above the phase's start, peak {mib(torch.cuda.max_memory_allocated()):.1f}"
          f" MiB (context, keys, 2x{N_CTS} ciphertexts, the kernel checks); butterfly tables "
          f"(kernels 1, 1b, 4, 5; no digit matrix) {tables:.1f} MiB for limbs {limbs}, of which "
          f"the fused route's {per_limb * len(fused):.1f} MiB for limbs {fused}")
    round16_route_check(w.sch, w.gen, device, card)
    limbs, after = butterfly_tables_mib(fntt, device)
    print(f"[memory N=2^16] after the route check ran kernel 1b on the big-route limbs: "
          f"butterfly tables {after:.1f} MiB for limbs {limbs} (+{after - tables:.1f} MiB)")
    return cases.take_launches(launches)


# ---------------------------------------------------------------------------
# Path 5: the butterfly configuration of the N=2^14 round
# ---------------------------------------------------------------------------

def butterfly_phase(card, device, w, default_outs, profile_on):
    """The N=2^14 round with ntt_impl="pallas" (kernel 6 runs every NTT) on
    the default round's keys and ciphertexts: kernel checks at its shapes,
    main path in both schedules, bit-equal to the default round, decrypt,
    ms/round."""
    import dataclasses

    import torch

    from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
    from ppqsflhe_tpu_torch.ops.cuda_ntt import BUTTERFLY

    t0 = time.perf_counter()
    sch = CkksScheme(dataclasses.replace(w.sch.params, ntt_impl=BUTTERFLY), device=device)
    print(f"[setup] the N={sch.params.n} round with ntt_impl={BUTTERFLY!r}: context "
          f"{time.perf_counter() - t0:.1f} s")
    bf, mq, n = sch.ctx.fntt, sch.ctx.moduli_qp, sch.params.n
    cases = KernelCases(card)
    # kernel 6 at the round's shapes: the lazy key switch's 2-limb transforms
    # over both components, and the full-level iNTT of c1 over Q
    for sel, polys, fwd in (((0, 1), 2 * N_CTS, True), ((0, 1), 2 * N_CTS, False),
                            ((0, 1, 2), N_CTS, False)):
        x = rand_residues([mq[i] for i in sel], (polys,), n, w.gen, device)
        run = lambda: (sch.ctx.ntt if fwd else sch.ctx.intt)(x, sel)
        plain = lambda: bf.plain(x, fwd, sel)
        cases.check(f"fourstep_ntt ({'forward' if fwd else 'inverse'}, limbs {list(sel)} x "
                    f"{polys} polys, N=2^14)", "fourstep_ntt", SRC_FS, K6, run(), plain(), run,
                    plain, 20, butterfly_work(len(sel), polys, bf.n1, bf.n2))
    torch.cuda.synchronize()

    mxu_route = ("mxu_ntt", "mxu_ntt_mont", "streamed_stage_a", "streamed_stage_b")
    need = ("fourstep_ntt", "base_extend", "ks_inner_product")
    outs, launches = drive_round("butterfly round", sch, w, {4: need, 0: need},
                                 absent=mxu_route)
    for lazy in (4, 0):
        same = all(torch.equal(a.data, b.data) for a, b in zip(outs[lazy], default_outs[lazy]))
        print(f"[butterfly round lazy={lazy}] bit-equal to the default round: {same}")
        if not same:
            raise AssertionError(f"butterfly round lazy={lazy} differs from the default round")
    time_round("butterfly round", sch, w, card, profile_on)
    # the two configurations in turns in this process: default, butterfly,
    # butterfly, default
    from ppqsflhe_tpu_torch.fl.api import server_round

    for lazy in (4, 0):
        turns = []
        for name, s in (("default", w.sch), ("butterfly", sch), ("butterfly", sch),
                        ("default", w.sch)):
            times = median_ms(lambda: server_round(s, w.ct1, w.ct2, w.rk12, w.rk21, lazy), 3)
            turns.append(f"{name} {statistics.median(times):.3f}")
        print(f"[A/B round lazy={lazy}] ms/round in turns: {', '.join(turns)} ({card})")
    return cases.take_launches(launches)


# ---------------------------------------------------------------------------
# Path 6: the seven FL tools on files at N=2^14
# ---------------------------------------------------------------------------

GRU_SHAPES = ([7, 192], [64, 192], [2, 192], [64, 192], [64, 192], [2, 192], [64, 1], [1])
# INDCCA hop: the flooding of 2^30 at Δ=2^40 costs about sqrt(N/2)·2^-10 per
# slot (docs/SECURITY.md:58): the RMS error must stay below it and the
# largest of the payload's 39,041 values below four times it
CCA_UNIT = (N_ROUND / 2) ** 0.5 * 2.0 ** -10
CONTEXTS = (("radix2/json", {}, "json"),
            ("fourstep/pqwd", {"ntt_backend": "fourstep", "ntt_impl": "pallas_mxu"}, "bin"))


def write_weights(path, rng):
    """One client's weights JSON in the GRU's Keras layout (39,041 values,
    uniform(-1, 1)) plus one optimizer layer the tools must skip."""
    import numpy as np

    summary = []
    for i, shape in enumerate(GRU_SHAPES):
        v = rng.uniform(-1, 1, int(np.prod(shape)))
        summary.append({"layer": f"param_{i}", "shape": shape, "mean": float(v.mean()),
                        "std_dev": float(v.std()), "values": v.tolist()})
    summary.append({"layer": "optimizer/iter", "shape": [1], "mean": 0.0, "std_dev": 0.0,
                    "values": [0.0]})
    with open(path, "w") as f:
        json.dump({"weights_summary": summary}, f)
    return {e["layer"]: np.asarray(e["values"]) for e in summary[:-1]}


def decrypt_err(doc, want):
    """(max, RMS) of |decrypted - want| over every value of every layer."""
    import numpy as np

    diffs = np.concatenate([np.asarray(e["values"]) - want[e["layer"]]
                            for e in doc["weights_summary"]])
    if len(doc["weights_summary"]) != len(want) or diffs.size != sum(v.size for v in want.values()):
        raise AssertionError("decrypted document lacks layers or values")
    return float(np.abs(diffs).max()), float(np.sqrt(np.mean(diffs ** 2)))


def files_kernel_checks(cases, sch, rk_mont, gen, device, tag):
    """Kernels 2 and 3 (and 1 for four-step) at the shapes the full-level
    changeCipherDomain of a 27-ciphertext document gives them."""
    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.ckks.eval import _ks_decomp_consts
    from ppqsflhe_tpu_torch.ops import cuda_ext
    from ppqsflhe_tpu_torch.ops.cuda_ks import ks_inner_product, ks_inner_product_plain

    ctx, n = sch.ctx, sch.params.n
    mq, L, K = ctx.moduli_qp, sch.params.num_q, sch.params.num_p
    idx_ext = ctx.q_idx(L) + ctx.p_idx()
    groups, consts = _ks_decomp_consts(ctx, L)
    for src, dst, pre, lead in ((groups[0], tuple(i for i in idx_ext if i not in groups[0]),
                                 consts[0], (N_CTS,)), (ctx.p_idx(), ctx.q_idx(L), None,
                                                        (2, N_CTS))):
        ext = ctx.extender(src, dst)
        xe = rand_residues([mq[i] for i in src], lead, n, gen, device)
        cases.check(f"base_extend ({tag}, {len(src)}->{len(dst)} limbs, "
                    f"{'pre' if pre is not None else 'ModDown'}, {'x'.join(map(str, lead))} "
                    f"polys, N=2^14)", "base_extend", SRC_EXT, K2,
                    cuda_ext.fused_extend(xe, ext, pre), ext.extend(xe, pre),
                    lambda: cuda_ext.fused_extend(xe, ext, pre), lambda: ext.extend(xe, pre),
                    50, ext_work(int(np.prod(lead)), len(src), len(dst), n))
    limbs = tuple(range(L + K))
    q, qinv, _ = ctx.limb_consts(limbs, device)
    sel = ctx.consts(("limb_map", limbs), lambda: limbs, device)
    dig = rand_residues(mq, (N_CTS, len(ctx.digit_groups)), n, gen, device)
    args = (dig, rk_mont.data, sel, q, qinv)
    cases.check(f"ks_inner_product ({tag}, nd={len(ctx.digit_groups)}, LK={len(limbs)}, "
                f"{N_CTS} polys, N=2^14)", "ks_inner_product", SRC_KS, K3,
                ks_inner_product(*args), ks_inner_product_plain(*args),
                lambda: ks_inner_product(*args), lambda: ks_inner_product_plain(*args), 50,
                ks_work(N_CTS, len(ctx.digit_groups), len(limbs), n))
    if not ctx.radix2:
        # kernel 1: the iNTT of c1 over Q at the start of the key switch
        idx = ctx.q_idx(L)
        x = rand_residues([mq[i] for i in idx], (N_CTS,), n, gen, device)
        fused_case(cases, ctx.fntt, x, idx, False, False, lambda: ctx.intt(x, idx), 20,
                   f"{tag}, 3 limbs x {N_CTS} polys, N=2^14")
    torch.cuda.synchronize()


def files_phase(card, device, profile_on):
    """The file round through the port's tools, in the radix-2/JSON and the
    four-step/PQWD contexts, then one INDCCA hop; ms per tool, device ms of
    the server's tools, radix-2 transform time. Returns the kernels' rows."""
    import tempfile

    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.ckks import serialize as ser
    from ppqsflhe_tpu_torch.fl import api

    dev = str(device)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        P = lambda name: os.path.join(tmp, name)
        rng = np.random.default_rng(SEED)
        want1, want2 = write_weights(P("w1.json"), rng), write_weights(P("w2.json"), rng)
        mean = {k: (want1[k] + want2[k]) / 2 for k in want1}
        with open(os.path.join(REPO, "configs", "config_cc.json")) as f:
            base_cfg = json.load(f)
        for tag, extra, container in CONTEXTS:
            cc = P(f"cc_{container}.json")
            e = lambda name: P(f"{name}.{container}")
            key = lambda name: P(f"{name}.key.{container}")
            api.gen_cc(dict(base_cfg, **extra), cc)
            times = {}

            def tool(name, fn, *a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                times[name] = (time.perf_counter() - t0) * 1e3
                return out

            ccd = lambda: api.change_cipher_domain(cc, key("rk12"), e("e1"), e("c12"), device=dev)
            agg = lambda: api.aggregate_encrypted_weights(cc, [e("c12"), e("e2")], e("agg"),
                                                          device=dev)
            reset_counts()
            for rep in ("cold", "warm"):
                tool("keyGen 1", api.key_gen, cc, key("pk1"), key("sk1"), seed=SEED + 1, device=dev)
                tool("keyGen 2", api.key_gen, cc, key("pk2"), key("sk2"), seed=SEED + 2, device=dev)
                tool("REkeyGen 1->2", api.rekey_gen, cc, key("sk1"), key("pk2"), key("rk12"),
                     seed=SEED + 3, device=dev)
                tool("REkeyGen 2->1", api.rekey_gen, cc, key("sk2"), key("pk1"), key("rk21"),
                     seed=SEED + 4, device=dev)
                tool("encrypt pk (v2)", api.encrypt_weights, cc, key("pk1"), P("w1.json"), e("e1"),
                     seed=SEED + 5, container=container, device=dev)
                tool("encrypt sk (v3)", api.encrypt_weights, cc, key("sk2"), P("w2.json"), e("e2"),
                     seed=SEED + 6, container=container, device=dev)
                tool("changeCipherDomain 1->2", ccd)
                tool("aggregate", agg)
                tool("changeCipherDomain 2->1", api.change_cipher_domain, cc, key("rk21"),
                     e("agg"), e("back"), device=dev)
                d2 = tool("decrypt 2", api.decrypt_weights, cc, key("sk2"), e("agg"), P("d2.json"),
                          device=dev)
                d1 = tool("decrypt 1", api.decrypt_weights, cc, key("sk1"), e("back"),
                          P("d1.json"), device=dev)
                if rep == "cold":
                    launches = read_counts()
                print(f"[files {tag} {rep}] ms per tool (wall, file I/O included): "
                      + ", ".join(f"{k} {v:.1f}" for k, v in times.items()) + f" ({card})")
            sch = api.load_scheme(cc, dev)
            n_cts = len(ser.load_enc_doc(e("e1"))["weights_summary"])
            docs = {k: ser.load_enc_doc(e(k)) for k in ("e1", "c12")}
            loaded = {k: api._stack(api._load_cts([f[3] for f in api._doc_fields(d)], sch))
                      for k, d in docs.items()}
            B = loaded["e1"].data.shape[0]
            if (B != N_CTS or n_cts != len(GRU_SHAPES)
                    or ser.doc_is_binary(e("e1")) != (container == "bin")):
                raise AssertionError(f"{tag}: {B} ciphertexts over {n_cts} layers "
                                     f"(want {N_CTS} over {len(GRU_SHAPES)}), container")
            rk12 = api._load_rekey_mont(sch, key("rk12"))
            mem = api.change_cipher_domain_batch(sch, rk12, loaded["e1"])
            same = torch.equal(mem.data, loaded["c12"].data) and mem.scale == loaded["c12"].scale
            e2, r2 = decrypt_err(d2, mean)
            e1, r1 = decrypt_err(d1, mean)
            print(f"[files {tag}] {B} ciphertexts per client; changeCipherDomain bit-equal to "
                  f"change_cipher_domain_batch: {same}; decrypt max err vs the plaintext mean: "
                  f"client 2 {e2:.3e}, client 1 {e1:.3e} (gate {ERR_GATE}); kernel launches "
                  f"{ {k: v for k, v in launches.items() if v} }")
            if not same:
                raise AssertionError(f"{tag}: changeCipherDomain differs from the in-memory batch")
            if not (np.isfinite(e1) and np.isfinite(e2) and max(e1, e2) < ERR_GATE):
                raise AssertionError(f"{tag}: decrypt error {max(e1, e2)} over the gate")
            need = ("base_extend", "ks_inner_product") + (() if sch.ctx.radix2 else ("mxu_ntt",))
            ntt_kernels = ("mxu_ntt", "mxu_ntt_mont", "streamed_stage_a", "streamed_stage_b",
                           "fourstep_ntt")
            missing = [k for k in need if launches[k] == 0]
            wrong = [k for k in ntt_kernels if launches[k]] if sch.ctx.radix2 else []
            if missing or wrong:
                raise AssertionError(f"{tag}: never launched {missing}; launched {wrong}")
            for name, fn in (("changeCipherDomain", ccd), ("aggregate", agg)):
                print(f"[files {tag}] {name}: device {show_us(device_ms(fn, 1))} per call "
                      f"(profiler, all device activities) ({card})")
            busy_line(f"files {tag} changeCipherDomain", ccd, times["changeCipherDomain 1->2"])
            if profile_on:
                profile_table(f"files {tag} changeCipherDomain", ccd)
            if sch.ctx.radix2:
                x = rand_residues(sch.ctx.moduli_qp[:3], (N_CTS,), sch.params.n,
                                  torch.Generator().manual_seed(SEED), device)
                for name, run in (("ntt", lambda: sch.ctx.ntt(x, (0, 1, 2))),
                                  ("intt", lambda: sch.ctx.intt(x, (0, 1, 2)))):
                    dms = device_ms(run, 3)
                    per = None if dms is None else dms / (3 * N_CTS)
                    print(f"[timing radix2 {name}] 3 limbs x {N_CTS} polys, N=2^14 (plain torch, "
                          f"{sch.params.n.bit_length() - 1} stages): device {show_us(dms)} per "
                          f"call, {show_us(per)} per limb-NTT; wall "
                          f"{cuda_ms(run, 3) * 1e3:.1f} us per call ({card})")
            cases = KernelCases(card)
            files_kernel_checks(cases, sch, rk12, torch.Generator().manual_seed(SEED), device,
                                tag)
            rows += cases.take_launches(launches)

        # one INDCCA hop on the radix-2 round's keys (same chain and order)
        cca = P("cc_cca.json")
        with open(os.path.join(REPO, "configs", "config_cc_indcca.json")) as f:
            api.gen_cc(json.load(f), cca)
        if api.load_scheme(cca, dev).params.pre_mode != "INDCCA":
            raise AssertionError("config_cc_indcca.json did not give an INDCCA context")
        t0 = time.perf_counter()
        api.change_cipher_domain(cca, P("rk12.key.json"), P("e1.json"), P("cca.json"),
                                 pub_path=P("pk2.key.json"), seed=SEED, device=dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        err, rms = decrypt_err(api.decrypt_weights(cca, P("sk2.key.json"), P("cca.json"),
                                                   P("dcca.json"), device=dev), want1)
        print(f"[files INDCCA] one hop 1->2 with the target public key: {ms:.1f} ms; decrypt "
              f"err max {err:.4f}, RMS {rms:.4f} (gates: RMS < sqrt(N/2)*2^-10 = {CCA_UNIT:.4f}, "
              f"max < {4 * CCA_UNIT:.4f}; predicted RMS sqrt(N/2)*2^30/sqrt(3)/2^40 = "
              f"{CCA_UNIT / 3 ** 0.5:.4f}) ({card})")
        if not (np.isfinite(err) and rms < CCA_UNIT and err < 4 * CCA_UNIT):
            raise AssertionError(f"INDCCA hop: error max {err}, RMS {rms} over the gate")
    return rows


# ---------------------------------------------------------------------------
# Path 7: the 16-client multikey round of bench_multikey.py at N=2^14
# ---------------------------------------------------------------------------

def multikey_kernel_checks(cases, sch, w, gen, device):
    """Kernels 1, 2 and 3 against their plain versions at the multikey
    round's shapes: the 154 c1 polys of one PRE and the 308 polys (both
    components) of its ModDown."""
    import numpy as np

    from ppqsflhe_tpu_torch.ckks.eval import _ks_decomp_consts
    from ppqsflhe_tpu_torch.ops import cuda_ext
    from ppqsflhe_tpu_torch.ops.cuda_ks import ks_inner_product, ks_inner_product_plain

    ctx, n = sch.ctx, sch.params.n
    mq = ctx.moduli_qp
    B = w.stacks.data.shape[1]
    # kernel 1: the iNTT of c1 over Q_2 (154 polys), the NTT back over Q_2
    # after the ModDown's extension (308 polys)
    for fwd, B_k in ((False, B), (True, 2 * B)):
        idx = (0, 1)
        x = rand_residues([mq[i] for i in idx], (B_k,), n, gen, device)
        run = (lambda: ctx.ntt(x, idx)) if fwd else (lambda: ctx.intt(x, idx))
        fused_case(cases, ctx.fntt, x, idx, fwd, False, run, 10,
                   f"2 limbs x {B_k} polys, N=2^14, multikey")
    # kernel 2 at the inbound (l=2) and lazy-4 outbound (l=1) levels: the
    # digit's extension to P (its constant folded in) over the 154 c1 polys,
    # and the ModDown P -> Q_l over both components (308 polys)
    for l in (2, 1):
        groups, consts = _ks_decomp_consts(ctx, l)
        for src, dst, pre, lead in ((groups[0], ctx.p_idx(), consts[0], (B,)),
                                    (ctx.p_idx(), ctx.q_idx(l), None, (2, B))):
            ext = ctx.extender(src, dst)
            xe = rand_residues([mq[i] for i in src], lead, n, gen, device)
            cases.check(f"base_extend (l={l}, {len(src)}->{len(dst)} limbs, "
                        f"{'pre' if pre is not None else 'ModDown'}, "
                        f"{'x'.join(map(str, lead))} polys, N=2^14, multikey)", "base_extend",
                        SRC_EXT, K2, cuda_ext.fused_extend(xe, ext, pre), ext.extend(xe, pre),
                        lambda: cuda_ext.fused_extend(xe, ext, pre), lambda: ext.extend(xe, pre),
                        20, ext_work(int(np.prod(lead)), len(src), len(dst), n))
    # kernel 3: one digit over LK = 4 (l=2) and 3 (l=1) limbs, 154 polys
    for l in (2, 1):
        limbs = tuple(ctx.q_idx(l)) + ctx.p_idx()
        q, qinv, _ = ctx.limb_consts(limbs, device)
        sel = ctx.consts(("limb_map", limbs), lambda: limbs, device)
        dig = rand_residues([mq[i] for i in limbs], (B, 1), n, gen, device)
        args = (dig, w.rk_to[0].data, sel, q, qinv)
        run, plain = lambda: ks_inner_product(*args), lambda: ks_inner_product_plain(*args)
        cases.check(f"ks_inner_product (nd=1, LK={len(limbs)}, {B} polys, l={l}, N=2^14, "
                    f"multikey)", "ks_inner_product", SRC_KS, K3, run(), plain(), run, plain, 20,
                    ks_work(B, 1, len(limbs), n))


def multikey_phase(card, device):
    """16 clients × 154 ciphertexts (the LSTM export, 1,091,101 values) at
    N=2^14: prep on the card, kernel checks, the round in both schedules
    with fresh launch counters (decrypt gates: the whole average under the
    hub's key, the outbound ciphertexts of clients 0 and 14 under theirs),
    then ms per round, rounds/s and the device's busy share. Returns the
    kernels' rows."""
    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.bench import multikey as mk
    from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme

    sch = CkksScheme(mk.params(), device=device)
    vecs, n_params = mk.payloads(SEED, MK_CLIENTS, sch.encoder.slots)
    t0 = time.perf_counter()
    w = mk.prep(sch, vecs, torch.Generator(device=device).manual_seed(SEED))
    B = w.stacks.data.shape[1]
    print(f"[setup multikey] {MK_CLIENTS} clients x {B} ciphertexts ({n_params} values each), "
          f"N={sch.params.n}: prep {time.perf_counter() - t0:.1f} s on the card (keygen "
          f"{w.seconds['keygen']:.1f}, {2 * (MK_CLIENTS - 1)} rekeys {w.seconds['rekeys']:.1f}, "
          f"{MK_CLIENTS * B} encryptions {w.seconds['encrypt']:.1f}); stacks "
          f"{w.stacks.data.numel() * 8 / 1e9:.2f} GB ({card})")
    if B != 154 or n_params != 1_091_101:
        raise AssertionError(f"multikey payload: {B} ciphertexts, {n_params} values")
    cases = KernelCases(card)
    multikey_kernel_checks(cases, sch, w, torch.Generator().manual_seed(SEED), device)
    staged = {lazy: mk.stage(w.stacks, mk.inbound_level(sch, lazy)) for lazy in (4, 0)}
    torch.cuda.synchronize()

    need = ("mxu_ntt", "base_extend", "ks_inner_product")
    reset_counts()
    per_sched = {}
    for lazy in (4, 0):
        before = read_counts()
        avg, outs = mk.server_round(sch, staged[lazy], w.rk_to, w.rk_from, lazy)
        torch.cuda.synchronize()
        per_sched[lazy] = {k: v - before[k] for k, v in read_counts().items()}
        errs = mk.check(sch, w, vecs, avg, outs)
        print(f"[multikey lazy={lazy}] kernel launches "
              f"{ {k: v for k, v in per_sched[lazy].items() if v} }; decrypt max err over all "
              f"{B} ciphertexts and slots: "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (gate {ERR_GATE}); average {tuple(avg.data.shape)} at {avg.nlimbs} limb(s), "
              f"outbound {tuple(outs.data.shape)} ({card})")
        missing = [k for k in need if per_sched[lazy][k] == 0]
        if missing:
            raise AssertionError(f"multikey lazy={lazy}: never launched {missing}")
        if not all(np.isfinite(e) and e < ERR_GATE for e in errs.values()):
            raise AssertionError(f"multikey lazy={lazy}: decrypt error {errs} over the gate")
        del avg, outs
    launches = read_counts()

    for lazy in (4, 0):
        m = mk.measure(sch, staged[lazy], w.rk_to, w.rk_from, lazy)
        print(f"[timing multikey lazy={lazy}] {m['ms']:.3f} ms/round, {m['rounds_per_sec']:.3f} "
              f"rounds/s ((t3 - t1)/2 over chained rounds: t1 {m['t1_ms']:.3f}, t3 "
              f"{m['t3_ms']:.3f} ms); {MK_CLIENTS} clients x {B} ciphertexts, N=2^14 ({card})")
        parts = ", ".join(f"{k} {v:.3f}" for k, v in m["by_kernel"].items())
        dev = "not measured" if m["device_ms"] is None else f"{m['device_ms']:.3f} ms"
        idle = "not measured" if m["idle_share"] is None else f"{m['idle_share']:.1%}"
        print(f"[busy multikey lazy={lazy}] device {dev} per round ({parts}); host enqueue "
              f"{m['enqueue_ms']:.3f} ms; idle share {idle} of {m['ms']:.3f} ms ({card})")
    return cases.take_launches(launches)


# ---------------------------------------------------------------------------
# Path 8: threshold CKKS at 16 parties, N=2^14
# ---------------------------------------------------------------------------

def smudge_sigma(parties, n, bits, scale):
    """The slot error's std-dev from ``parties`` floods uniform in
    ±2^bits per coefficient: √(P·N/6)·2^bits / scale."""
    return (parties * n / 6) ** 0.5 * 2.0 ** bits / scale


def slot_errors(sch, coeffs, ct, want):
    """(RMS, max) of decoded − want over every ciphertext of the batch and
    every slot."""
    import numpy as np

    from ppqsflhe_tpu_torch.bench.multikey import slot_diffs

    d = slot_diffs(sch, coeffs, ct, want)
    return float(np.sqrt(np.mean(d ** 2))), float(np.abs(d).max())


def threshold_phase(card, device):
    """16 parties on the N=2^14 chain: the CRS (bit-equal to the JAX
    package's, by hash), 16 key shares and the joint key, each party's
    154-ciphertext payload encrypted under it, ``multikey.aggregate_local``,
    16 batched partial decryptions and the fusion (smudging 2^30, then
    none), then Shamir 9-of-16: the sets {1..9} and {8..16} decrypt, {1..8}
    does not. Returns the kernels' rows."""
    import hashlib

    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.bench import multikey as mk
    from ppqsflhe_tpu_torch.ckks import multikey, threshold as th
    from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
    from ppqsflhe_tpu_torch.convert import residues_np
    from ppqsflhe_tpu_torch.core import jax_prng

    sch = CkksScheme(mk.params(), device=device)
    ctx, n = sch.ctx, sch.params.n
    cases = KernelCases(card)
    # kernel 1 at the CRS's shape: one poly over the 5 QP limbs, and the
    # Shamir coefficients' 8 polys
    all_idx = tuple(range(len(ctx.moduli_qp)))
    crs_coeff = torch.from_numpy(jax_prng.uniform_rns(CRS_SEED, ctx.moduli_qp, n).view(
        np.int64)).to(device)
    gen_k = torch.Generator().manual_seed(SEED)
    for tag, x in (("CRS", crs_coeff[None]),
                   ("Shamir", rand_residues(ctx.moduli_qp, (TH_T - 1,), n, gen_k, device))):
        fused_case(cases, ctx.fntt, x, all_idx, True, False, lambda: ctx.ntt(x, all_idx), 10,
                   f"5 QP limbs x {x.shape[0]} polys, N=2^14, threshold {tag}")
    vecs, _ = mk.payloads(SEED + 1, TH_PARTIES, sch.encoder.slots)
    mean = [np.mean([v[k] for v in vecs], axis=0) for k in range(len(vecs[0]))]
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    torch.cuda.synchronize()

    reset_counts()
    times = {}

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    a = step("CRS", lambda: th.common_random_poly(ctx, CRS_SEED, device))
    digest = hashlib.sha256(residues_np(a).astype("<u8").tobytes()).hexdigest()
    print(f"[threshold] CRS seed {CRS_SEED:#x}: SHA-256 of its {tuple(a.shape)} residues "
          f"{digest} (the JAX package's: {CRS_SHA256}) ({card})")
    if digest != CRS_SHA256:
        raise AssertionError("the CRS differs from the JAX package's")
    parts = step(f"{TH_PARTIES} partial_keygen", lambda: [th.partial_keygen(ctx, a, gen)
                                               for _ in range(TH_PARTIES)])
    shares = [s for s, _ in parts]
    pk = step("joint_public_key", lambda: th.joint_public_key(ctx, a, [b for _, b in parts]))
    cts = step(f"encrypt {TH_PARTIES} x {len(vecs[0])}",
               lambda: [sch.encrypt_values(pk, v, gen) for v in vecs])
    agg = step("aggregate_local", lambda: multikey.aggregate_local(ctx, cts))
    del cts
    results = {}
    for bits in (th.DEFAULT_SMUDGING_BITS, 0):
        coeffs = step(f"{TH_PARTIES} partial_decrypt + fuse (bits={bits})",
                      lambda: th.fuse_partial_decryptions(
                          ctx, agg, [th.partial_decrypt(ctx, s, agg, gen, bits) for s in shares]))
        results[f"N-of-N bits={bits}"] = (slot_errors(sch, coeffs, agg, mean), TH_PARTIES, bits)
    outgoing = step(f"{TH_PARTIES} shamir_share_secret (t={TH_T})", lambda: [
        th.shamir_share_secret(ctx, s, TH_PARTIES, TH_T, gen) for s in shares])
    sigmas = step(f"{TH_PARTIES} aggregate_received_shares", lambda: {
        j: th.aggregate_received_shares(ctx, torch.stack([o[j - 1] for o in outgoing]))
        for j in range(1, TH_PARTIES + 1)})
    del outgoing
    for pset in (tuple(range(1, TH_T + 1)), tuple(range(TH_PARTIES - TH_T + 1, TH_PARTIES + 1)),
                 tuple(range(1, TH_T))):
        coeffs = step(f"t-of-N {pset[0]}..{pset[-1]}", lambda: th.fuse_partial_decryptions(
            ctx, agg, [th.partial_decrypt_t(ctx, sigmas[j], agg, pset, j, gen) for j in pset]))
        results[f"set {pset[0]}..{pset[-1]}"] = (slot_errors(sch, coeffs, agg, mean), len(pset),
                                                 th.DEFAULT_SMUDGING_BITS)
    launches = read_counts()
    print(f"[threshold] kernel launches { {k: v for k, v in launches.items() if v} }; ms per "
          f"step (synchronized): " + ", ".join(f"{k} {v:.1f}" for k, v in times.items())
          + f" ({card})")
    if launches["mxu_ntt"] == 0 or launches["base_extend"] or launches["ks_inner_product"]:
        raise AssertionError("threshold: kernel 1 must launch, kernels 2 and 3 must not")
    failures = []
    for name, ((rms, mx), parties, bits) in results.items():
        sig = smudge_sigma(parties, n, bits, agg.scale)
        strict = name.endswith(f"1..{TH_T - 1}")
        if strict:
            ok, gate = mx > 1.0, "must fail: max > 1.0"
        elif bits == 0:
            ok, gate = mx < ERR_GATE, f"max < {ERR_GATE}"
        else:
            ok = 0.9 * sig <= rms <= 1.1 * sig and mx < 6 * sig
            gate = (f"RMS in 0.9-1.1 sigma, max < 6 sigma; sigma = "
                    f"sqrt({parties}*N/6)*2^{bits}/scale")
        print(f"[threshold {name}] {len(mean)} ciphertexts x {sch.encoder.slots} slots: error RMS "
              f"{rms:.4e}, max {mx:.4e}"
              + ("" if strict or bits == 0 else f", sigma {sig:.4f} (RMS/sigma {rms / sig:.3f}, "
                 f"max/sigma {mx / sig:.2f})")
              + f"; gate: {gate}: {'held' if ok else 'FAILED'} ({card})")
        if not ok:
            failures.append(name)
    if failures:
        raise AssertionError(f"threshold: gates failed for {failures}")
    return cases.take_launches(launches)


# ---------------------------------------------------------------------------
# Path 9: kernel 7, the tensor-core / integer-chain overlap probe
# ---------------------------------------------------------------------------

def probe_work(kind, x8, m):
    """(bytes, int8 operations) of one probe launch over all K cells."""
    K, W, c = x8.shape
    out = 4 * K * m * c
    if kind == "vpu":
        return K * m * c + out, 0
    return K * W * c + m * W + out, 2 * K * m * W * c


def probe_library(x8, a, m, card):
    """The mxu order's library yardstick: one ``torch._int_mm(A[:m], B)``
    over all K cells, with B = the (W, K·c) operand Xp stored row-major and
    stored K-major (Xp transposed), each made before the timed window and
    timed on a line of its own; then K per-cell calls. → (device ms of the
    faster one-call layout, its output as (K, m, c) uint32 values)."""
    import torch

    K, W, c = x8.shape
    am = a[:m].contiguous()
    permute = lambda: x8.permute(1, 0, 2).reshape(W, K * c).contiguous()
    xp = permute()
    transpose = lambda: xp.t().contiguous()
    xk = transpose().t()                    # (W, K·c), strides (1, W): K-major
    outs = {}
    for tag, b in (("row-major", xp), ("K-major", xk)):
        one = lambda b=b: torch._int_mm(am, b)
        outs[tag] = (device_ms(one, 20), cuda_ms(one, 20), one())
    cells = [x8[k] for k in range(K)]
    per_cell = device_ms(lambda: [torch._int_mm(am, xc) for xc in cells], 3)
    if not torch.equal(outs["row-major"][2], outs["K-major"][2]):
        raise AssertionError("torch._int_mm differs between B row-major and B K-major")
    for tag, (dev, wall, _) in outs.items():
        print(f"[probe] library: one torch._int_mm(A[:m], B) over all {K} cells, B {tag}: "
              f"device {show_us(dev)}, wall {wall * 1e3:.1f} us ({card})")
    print(f"[probe] library operands (outside those windows): the permute that makes Xp "
          f"{show_us(device_ms(permute, 20))}, its transpose to K-major "
          f"{show_us(device_ms(transpose, 20))}; {K} calls, one per cell: device "
          f"{show_us(per_cell)} per set ({card})")
    timed = [(dev, tag) for tag, (dev, _, _) in outs.items() if dev is not None]
    best = min(timed) if timed else (None, "none")
    print(f"[probe] library_ms: the faster layout, {best[1]}: {show_us(best[0])}")
    want = outs["row-major"][2].reshape(m, K, c).permute(1, 0, 2).to(torch.int64) & 0xFFFFFFFF
    return best[0], want


def probe_phase(card, device):
    """Kernel 7 at the TPU probe's shapes: bit-equal to its plain version
    for the four kinds with carry 0, a chained carry and -91, in every call
    that is timed or profiled too; torch._int_mm (one call over all cells)
    as the mxu kind's library call; then µs/cell scan-marginally (the main
    path), which the JSON rows carry as ``ms``."""
    import torch

    from ppqsflhe_tpu_torch.probes import mxu_vpu_overlap as pr

    x8, a = pr.inputs(device, seed=0)
    K, W, c = x8.shape
    m = pr.M
    lib_ms, want_mxu = probe_library(x8, a, m, card)
    cases = KernelCases(card)
    crafted = torch.tensor([[[0x1A5]]], dtype=torch.int32, device=device)   # carry -91
    for kind in pr.KINDS:
        want = pr.probe_plain(kind, x8, a, None, m)
        got = pr.probe(kind, x8, a, None, m)
        # every output of the timed and profiled calls is kept (its own
        # buffer) and compared; none of them can reuse a freed buffer that
        # holds this answer, since every such buffer is kept or poisoned
        kept, kept_plain = [], []
        cases.check(f"overlap_probe ({kind}, K={K}, m={m}, nd={pr.ND}, c={pr.C})",
                    "overlap_probe", SRC_PROBE, K7, got, want,
                    lambda: kept.append(pr.probe(kind, x8, a, None, m)),
                    lambda: kept_plain.append(pr.probe_plain(kind, x8, a, None, m)), 20,
                    probe_work(kind, x8, m), library_ms=lib_ms if kind == "mxu" else None)
        bad = sum(not torch.equal(o, want) for o in kept)
        if bad:
            raise AssertionError(f"overlap_probe {kind}: {bad} of the {len(kept)} timed and "
                                 "profiled calls differ from plain")
        print(f"[probe] {kind}: all {len(kept)} timed and profiled calls bit-equal to plain")
        for prev in (got, crafted):       # a chained carry and a non-zero one
            if not torch.equal(pr.probe(kind, x8, a, prev, m),
                               pr.probe_plain(kind, x8, a, prev, m)):
                raise AssertionError(f"overlap_probe {kind}: differs from plain with carry "
                                     f"{pr.carry_byte(prev)}")
        if kind == "mxu" and not torch.equal(got.to(torch.int64) & 0xFFFFFFFF, want_mxu):
            raise AssertionError("overlap_probe mxu differs from torch._int_mm")
        for o in kept + kept_plain + [got, want]:
            o.fill_(pr.POISON)
        del kept, kept_plain, got, want
    print(f"[probe] kernel 7 bit-equal to its plain version for {list(pr.KINDS)} with carry 0 "
          f"and {pr.carry_byte(crafted)}; mxu = one torch._int_mm over all cells")
    torch.cuda.synchronize()

    reset_counts()
    us = pr.measure(x8, a, m)
    launches = read_counts()
    if launches["overlap_probe"] == 0:
        raise AssertionError("the probe never launched kernel 7")
    print(f"[probe] the main path's {launches['overlap_probe']} launches (each replay of a "
          f"chain counted) all bit-equal to plain")
    ctas = len(pr.cta_grid(K, m))
    print(f"[probe] design: wgmma, {ctas // K} CTAs a cell ({ctas} CTAs), "
          f"{pr.WARPGROUPS['consumer']} consumer + {pr.WARPGROUPS['producer']} producer "
          f"warpgroups a CTA")
    print(f"[probe] us/cell (scan-marginal over R={pr.R_LO} and R={pr.R_HI} chained launches, "
          f"each chain one CUDA graph, K={K} cells): "
          + ", ".join(f"{k} {v:.4f}" for k, v in us.items()) + "; us per launch: "
          + ", ".join(f"{k} {v * K:.2f}" for k, v in us.items()) + f" ({card})")
    for row, kind in zip(cases.rows, pr.KINDS):
        row.update(ms=us[kind] * K * 1e-3, timing="scan", profiler_ms=row["ms"])
        print(f"[probe] {kind}: row ms = the scan, {us[kind] * K:.2f} us per launch; the "
              f"profiler's per call {show_us(row['profiler_ms'])}")
    bound_ms, _ = bound(probe_work("mxu", x8, m))
    ops = probe_work("mxu", x8, m)[1]
    mxu_s = us["mxu"] * K * 1e-6
    ratio = "not measured" if lib_ms is None else f"{lib_ms * 1e-3 / mxu_s:.2f}x"
    print(f"[probe] mxu: {bound_ms * 1e-3 / mxu_s:.1%} of its {bound_ms * 1e3:.2f} us bound; "
          f"int8 rate {ops / mxu_s / 1e12:.1f} T/s = {ops / mxu_s / INT8_OPS:.1%} of "
          f"{INT8_OPS / 1e12:,.0f} T/s; one torch._int_mm {show_us(lib_ms)} ({ratio} the "
          f"kernel's time)")
    lo, hi = max(us["mxu"], us["vpu"]), us["mxu"] + us["vpu"]
    print(f"[probe] inter {us['inter']:.4f} vs max(mxu, vpu) {lo:.4f} and mxu+vpu {hi:.4f}: "
          f"{(hi - us['inter']) / max(hi - lo, 1e-9):.0%} of the possible overlap (the TPU "
          f"script's reading); serial {us['serial']:.4f}")
    # serial runs both chains exposed, inter only chain(dot1): chain(dot0)
    # is (serial - mxu) / 2 and inter hides serial - inter of it
    hideable = (us["serial"] - us["mxu"]) / 2
    print(f"[probe] inter hides {(us['serial'] - us['inter']) / max(hideable, 1e-9):.0%} of "
          f"chain(dot0) ({hideable:.4f} us/cell) behind dot1's products ({card})")
    return cases.take_launches(launches)


# ---------------------------------------------------------------------------
# Path 10: the orchestrated FL loop (training, artifact server, rounds)
# ---------------------------------------------------------------------------

ORCH_HOURS = 31 * 24     # the synthetic CSVs: hourly, 2024-07-01 to 2024-07-31
ORCH_EPOCHS = 3          # depth cut: the example configs say 100 (patience 4)
ORCH_BATCH = 32


def write_series(path, seed):
    """One client's training CSV in the reference layout (Timestamp as
    DD-MM-YYYY HH:MM, Data): hourly over July 2024, a daily sine plus
    normal(0, 2) noise from ``numpy.random.default_rng(seed)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ts = np.datetime64("2024-07-01T00:00") + np.arange(ORCH_HOURS).astype("timedelta64[h]")
    vals = (100 + 20 * np.sin(2 * np.pi * (np.arange(ORCH_HOURS) % 24) / 24)
            + rng.normal(0, 2, ORCH_HOURS))
    with open(path, "w") as f:
        f.write("Timestamp,Data\n")
        for t, v in zip(ts.astype(object), vals):
            f.write(f"{t.strftime('%d-%m-%Y %H:%M')},{float(v)!r}\n")


def oconfig(name, tmp, tag, rounds, cc_extra=None):
    """An example oConfig as written, cut to ``rounds`` and ORCH_EPOCHS,
    with fail-fast on, its work dir under ``tmp`` and synthetic CSVs in
    place of the reference's (not in the repository)."""
    with open(os.path.join(REPO, "configs", name)) as f:
        doc = json.load(f)
    doc.update(ROUNDS=rounds, WORK_DIR=os.path.join(tmp, tag), FAIL_FAST=True)
    doc["CC_CONFIG"] = dict(doc["CC_CONFIG"], **(cc_extra or {}))
    clients = []
    for i, c in enumerate(doc["CLIENT_CONFIGS"], start=1):
        path = os.path.join(tmp, f"{tag}_client{i}.csv")
        write_series(path, SEED + 10 * ord(tag[0]) + i)
        clients.append(dict(c, data_file=path, epochs=ORCH_EPOCHS))
    doc["CLIENT_CONFIGS"] = clients
    return doc


def layers(path):
    import numpy as np

    with open(path) as f:
        return [np.asarray(e["values"]) for e in json.load(f)["weights_summary"]]


def decrypted_params(cfg, i, device):
    """Client ``i``'s decrypted weights as the GRU's parameter list."""
    from ppqsflhe_tpu_torch.train import gru

    with open(os.path.join(cfg.work_dir, f"client_{i}", "decrypted_weights.json")) as f:
        return gru.summary_to_params(json.load(f)["weights_summary"], device)


def aggregate_checks(tag, cfg, results, exported, sigma=None):
    """No client dropped in any round (a kernel failure must not turn into a
    dropout); every client's decrypt equals the mean of the exported
    weights — within ERR_GATE, or for threshold within the flood's σ (RMS
    0.9–1.1 σ, max < 6 σ, phase 8's gate) — and the clients agree."""
    import numpy as np

    dropped = [r["dropped"] for r in results]
    if any(dropped):
        raise AssertionError(f"orchestrated {tag}: clients dropped {dropped}")
    want = np.concatenate([np.mean(v, axis=0) for v in zip(*[layers(p) for p in exported])])
    decs = [np.concatenate(layers(os.path.join(cfg.work_dir, f"client_{i}",
                                               "decrypted_weights.json")))
            for i in range(1, cfg.n_clients + 1)]
    diff = np.stack(decs) - want          # every client's decrypt
    mx, rms = float(np.abs(diff).max()), float(np.sqrt(np.mean(diff ** 2)))
    agree = max(float(np.abs(d - decs[0]).max()) for d in decs)
    if sigma is None:
        ok, gate = mx < ERR_GATE, f"max < {ERR_GATE}"
    else:
        ok = 0.9 * sigma < rms < 1.1 * sigma and mx < 6 * sigma
        gate = f"RMS in 0.9-1.1 sigma, max < 6 sigma; sigma = sqrt(P*N/6)*2^30/scale = {sigma:.4f}"
    print(f"[orchestrated {tag}] rounds {[r['round'] for r in results]}, dropped {dropped}; "
          f"{want.size} values: each decrypt vs mean of the exports max {mx:.3e}, RMS {rms:.3e} "
          f"({gate}); clients agree within {agree:.3e}")
    if not (ok and np.isfinite(mx) and agree < ERR_GATE):
        raise AssertionError(f"orchestrated {tag}: aggregate gate failed (max {mx}, RMS {rms}, "
                             f"agreement {agree})")


def validation(ccfg, device):
    """A client's validation windows, as its trainer makes them, on ``device``."""
    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.train import data as D
    from ppqsflhe_tpu_torch.train import trainer as T

    train_df, _, fs, ts = T._frames(ccfg)
    X, y = D.prepare_sequences(train_df, int(ccfg.get("lookback", 72)), fs, ts)
    X_tr, y_tr, X_val, y_val = D.train_val_split(X, y)
    dev = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    return dev(X_tr), dev(y_tr), dev(X_val), dev(y_val)


def training_checks(tag, cfg, results, device, warm=None):
    """Round 1 from a fresh init lowers every client's validation MSE; with
    ``warm`` (client → round 1's decrypted weights), round 2 started from
    exactly those weights (its validation MSE before the first step is
    theirs); the forward on the card matches the CPU's at the final
    decrypt (atol 1e-4)."""
    from ppqsflhe_tpu_torch.train import gru
    from ppqsflhe_tpu_torch.train import trainer as T

    for r in results:
        for i, t in sorted(r["training"].items()):
            print(f"[orchestrated {tag} round {r['round']}] client_{i}: {t['epochs']} epochs, "
                  f"val MSE {t['val_mse_init']:.5f} -> {t['val_mse']:.5f} (best epoch "
                  f"{t['best_epoch']}), warm start {'yes' if t['warm_start'] else 'no'}")
    first = next(r for r in results if r["round"] == 1)
    if len(first["training"]) != cfg.n_clients or any(
            t["warm_start"] or not t["val_mse"] < t["val_mse_init"]
            for t in first["training"].values()):
        raise AssertionError(f"orchestrated {tag}: round 1 did not lower every client's "
                             f"validation MSE from a fresh init")
    for i, params in (warm or {}).items():
        t = next(r for r in results if r["round"] == 2)["training"][i]
        *_, Xv, yv = validation(cfg.client_configs[i - 1], device)
        want = T.eval_mse(gru.Model(params).to(device), Xv, yv)
        print(f"[orchestrated {tag} round 2] client_{i} started from round 1's decrypt: val MSE "
              f"there {want:.6f}, the trainer's before its first step {t['val_mse_init']:.6f}")
        if t["warm_start"] is None or abs(want - t["val_mse_init"]) > 1e-6 * abs(want):
            raise AssertionError(f"orchestrated {tag}: client_{i} did not warm-start from "
                                 f"round 1's decrypt")
    *_, Xv, _ = validation(cfg.client_configs[0], device)
    params = decrypted_params(cfg, 1, "cpu")
    got = T.predict(gru, [p.to(device) for p in params], Xv.cpu().numpy(), device)
    want = T.predict(gru, params, Xv.cpu().numpy(), "cpu")
    err = float(abs(got - want).max())
    print(f"[orchestrated {tag}] GRU forward on the card vs the CPU at client_1's final decrypt, "
          f"{tuple(Xv.shape)} windows: max |diff| {err:.3e} (gate 1e-4)")
    if not err < 1e-4:
        raise AssertionError(f"orchestrated {tag}: card forward differs from the CPU's by {err}")


def print_rounds(tag, log, card):
    from ppqsflhe_tpu_torch.bench.orchestrated import step_tables

    for t in step_tables(log):
        print(f"[timing orchestrated {tag} round {t['round']}] {t['total_s']} s (host clock, "
              f"step log): " + ", ".join(f"{s['step']} {s['ms']}" for s in t["steps"])
              + f" ms ({card})")


def orchestrated_kernel_checks(cases, cfg, device, tag):
    """Kernels 2 and 3 (PRE) or 1 (threshold, four-step) against their plain
    versions at the run's shapes: one client's ciphertext batch at each level
    the run's key switches use (lazy: l = L - 1 in, l = 1 out), or over Q
    forward and back."""
    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.ckks import serialize as ser
    from ppqsflhe_tpu_torch.ckks.eval import _ks_decomp_consts
    from ppqsflhe_tpu_torch.fl import api
    from ppqsflhe_tpu_torch.ops import cuda_ext
    from ppqsflhe_tpu_torch.ops.cuda_ks import ks_inner_product, ks_inner_product_plain

    store = os.path.join(cfg.work_dir, "server_storage")
    sch = api.load_scheme(os.path.join(store, "CC.json"), device)
    ctx, n, L = sch.ctx, sch.params.n, sch.params.num_q
    mq = ctx.moduli_qp
    doc = ser.load_enc_doc(os.path.join(store, "client_1", "encrypted_weights_c1.json"))
    B = len(list(api._doc_fields(doc)))
    gen = torch.Generator().manual_seed(SEED)
    where = f"N=2^{n.bit_length() - 1}, orchestrated {tag}"
    if cfg.protocol == "threshold":
        idx = ctx.q_idx(L)
        x = rand_residues([mq[i] for i in idx], (B,), n, gen, device)
        for fwd in (True, False):
            run = (lambda: ctx.ntt(x, idx)) if fwd else (lambda: ctx.intt(x, idx))
            fused_case(cases, ctx.fntt, x, idx, fwd, False, run, 20,
                       f"{L} limbs x {B} polys, {where}")
        return
    rk = api._load_rekey_mont(sch, os.path.join(store, "client_1", "client_1-to-2-ReKey.key"))
    for l in (L - 1, 1) if cfg.lazy_levels else (L,):
        groups, consts = _ks_decomp_consts(ctx, l)
        idx_ext = ctx.q_idx(l) + ctx.p_idx()
        steps = [(g, tuple(i for i in idx_ext if i not in g), c, (B,))
                 for g, c in zip(groups, consts)] + [(ctx.p_idx(), ctx.q_idx(l), None, (2, B))]
        for src, dst, pre, lead in steps:
            ext = ctx.extender(src, dst)
            xe = rand_residues([mq[i] for i in src], lead, n, gen, device)
            cases.check(f"base_extend (l={l}, {len(src)}->{len(dst)} limbs, "
                        f"{'pre' if pre is not None else 'ModDown'}, "
                        f"{'x'.join(map(str, lead))} polys, {where})", "base_extend", SRC_EXT, K2,
                        cuda_ext.fused_extend(xe, ext, pre), ext.extend(xe, pre),
                        lambda: cuda_ext.fused_extend(xe, ext, pre), lambda: ext.extend(xe, pre),
                        20, ext_work(int(np.prod(lead)), len(src), len(dst), n))
        limbs = ctx.q_idx(l) + ctx.p_idx()
        q, qinv, _ = ctx.limb_consts(limbs, device)
        sel = ctx.consts(("limb_map", limbs), lambda: limbs, device)
        dig = rand_residues([mq[i] for i in limbs], (B, len(groups)), n, gen, device)
        args = (dig, rk.data, sel, q, qinv)
        run, plain = lambda: ks_inner_product(*args), lambda: ks_inner_product_plain(*args)
        cases.check(f"ks_inner_product (nd={len(groups)}, LK={len(limbs)}, l={l}, {B} polys, "
                    f"{where})",
                    "ks_inner_product", SRC_KS, K3, run(), plain(), run, plain, 20,
                    ks_work(B, len(groups), len(limbs), n))
    torch.cuda.synchronize()


def host_ms_once(fn):
    """Host milliseconds of one call of ``fn``, the device drained before and
    after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def drive(tag, cfg, need, resume=False):
    """One drive of ``cfg`` through ``Orchestrator.run`` (its step log on
    stderr), the launch counts set to 0 just before and read just after;
    fails unless every kernel of ``need`` launched. Returns (results, log,
    counts)."""
    import torch

    from ppqsflhe_tpu_torch.bench.orchestrated import run

    reset_counts()
    t0 = time.perf_counter()
    results, log, _ = run(cfg, resume)
    torch.cuda.synchronize()
    counts = read_counts()
    missing = [k for k in need if counts[k] == 0]
    print(f"[orchestrated {tag}] {time.perf_counter() - t0:.1f} s; kernel launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if missing:
        raise AssertionError(f"orchestrated {tag}: never launched {missing}")
    return results, log, counts


def orchestrated_phase(card, device):
    """Runs A (PRE with training, 2 rounds), B (the bench twin) and C
    (threshold at 4 clients with training, four-step NTT), each with
    fail-fast in a temporary directory; their gates, kernel checks, warm
    rounds, ms per training step and epoch, and the device's idle share
    over one epoch and one warm round. Returns the kernels' rows."""
    import dataclasses
    import tempfile

    import torch

    from ppqsflhe_tpu_torch.bench import orchestrated
    from ppqsflhe_tpu_torch.ckks import serialize as ser
    from ppqsflhe_tpu_torch.ckks.threshold import DEFAULT_SMUDGING_BITS
    from ppqsflhe_tpu_torch.fl import api
    from ppqsflhe_tpu_torch.orchestration import cli
    from ppqsflhe_tpu_torch.train import gru
    from ppqsflhe_tpu_torch.train import trainer as T

    dev = str(device)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the trainer's matmuls must stay float32")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        # run A: PRE with training, round 1 then round 2 through resume
        doc = oconfig("oConfig.example.json", tmp, "A", rounds=1)
        cfg1 = cli.config(doc, dev)
        res1, log1, c1 = drive("A round 1", cfg1, ("base_extend", "ks_inner_product"))
        clients = range(1, cfg1.n_clients + 1)
        warm = {i: decrypted_params(cfg1, i, dev) for i in clients}
        cfg = dataclasses.replace(cfg1, rounds=2)
        res2, log2, c2 = drive("A round 2 (resume)", cfg, ("base_extend", "ks_inner_product"),
                               resume=True)
        results = res1 + res2
        aggregate_checks("A", cfg, results,
                         [os.path.join(cfg.work_dir, f"client_{i}", "weights.json")
                          for i in clients])
        training_checks("A", cfg, results, device, warm)
        print_rounds("A", log1, card)
        print_rounds("A", log2, card)
        cases = KernelCases(card)
        orchestrated_kernel_checks(cases, cfg, device, "A")
        rows += cases.take_launches({k: c1[k] + c2[k] for k in c1})

        # ms per training step and epoch at full width, and the epoch's idle share
        Xt, yt, _, _ = validation(cfg.client_configs[0], device)
        model = gru.Model(warm[1]).to(device)
        opt = T.make_optimizer(model)
        shuffle, drop = torch.Generator().manual_seed(SEED), torch.Generator(
            device=device).manual_seed(SEED)

        def epoch():
            n_steps = len(T.run_epoch(model, opt, Xt, yt, ORCH_BATCH, shuffle, drop))
            torch.cuda.synchronize()
            return n_steps

        steps = epoch()
        epoch_ms = host_ms_once(epoch)
        xb, yb = Xt[:ORCH_BATCH], yt[:ORCH_BATCH]
        step_ms = statistics.median(host_ms_once(
            lambda: (T.train_step(model, opt, xb, yb, drop), torch.cuda.synchronize()))
            for _ in range(5))
        print(f"[timing orchestrated train] GRU 7 -> 64 -> 64 -> 1 (39,041 params), lookback "
              f"{tuple(Xt.shape)[1]}, batch {ORCH_BATCH}: {step_ms:.2f} ms per step (median of "
              f"5), {epoch_ms:.1f} ms per epoch of {steps} steps ("
              f"{epoch_ms / steps:.2f} ms per step), synchronized host clock ({card})")
        t0 = time.perf_counter()
        busy_line("orchestrated epoch", epoch, epoch_ms, once=True)
        print(f"[orchestrated] the epoch's profile took {time.perf_counter() - t0:.1f} s")

        # run B: the bench twin (train=False, reference chain, PQWD wire)
        work = os.path.join(tmp, "B")
        os.makedirs(work)
        cfgb = dataclasses.replace(orchestrated.config(work, dev), fail_fast=True)
        resb, logb, cb = drive("B", cfgb, ("base_extend", "ks_inner_product"))
        aggregate_checks("B", cfgb, resb, [os.path.join(work, f"w{i}.json") for i in (1, 2)])
        print_rounds("B", logb, card)
        bench = orchestrated.summary(logb, 0.0)
        print(f"[timing orchestrated B] warm round {bench['value']} s "
              f"(orchestrated_round_s_warm) ({card})")
        cases = KernelCases(card)
        orchestrated_kernel_checks(cases, cfgb, device, "B")
        rows += cases.take_launches(cb)
        state = os.path.join(cfgb.work_dir, "orchestrator_state.json")

        def warm_round():
            with open(state) as f:
                done = json.load(f)["completed_rounds"]
            orchestrated.run(dataclasses.replace(cfgb, rounds=done + 1), resume=True)

        round_ms = statistics.median(host_ms_once(warm_round) for _ in range(2))
        busy_line("orchestrated B warm round", warm_round, round_ms, once=True)

        # run C: threshold at 4 clients with training, the four-step NTT
        doc = oconfig("oConfig.threshold.example.json", tmp, "C", rounds=1,
                      cc_extra={"ntt_backend": "fourstep"})
        cfgc = cli.config(doc, dev)
        resc, logc, cc = drive("C", cfgc, ("mxu_ntt",))
        agg = ser.load_enc_doc(os.path.join(cfgc.work_dir, "server_storage",
                                            "aggregated_weights.json"))
        sch = api.load_scheme(os.path.join(cfgc.work_dir, "server_storage", "CC.json"), dev)
        scale = api._load_cts([next(api._doc_fields(agg))[3]], sch)[0].scale
        aggregate_checks("C", cfgc, resc,
                         [os.path.join(cfgc.work_dir, f"client_{i}", "weights.json")
                          for i in range(1, cfgc.n_clients + 1)],
                         sigma=smudge_sigma(cfgc.n_clients, sch.params.n, DEFAULT_SMUDGING_BITS,
                                            scale))
        training_checks("C", cfgc, resc, device)
        print_rounds("C", logc, card)
        cases = KernelCases(card)
        orchestrated_kernel_checks(cases, cfgc, device, "C")
        rows += cases.take_launches(cc)
    return rows


# ---------------------------------------------------------------------------
# Path 11: the bench twins, and the FLEXIBLEAUTOEXT chain and OpenFHE wire
# ---------------------------------------------------------------------------

TWIN_REPS = 2        # repetitions of each timed chain (the twins' own default: 3)


def flexext_kernel_checks(cases, gen, device):
    """Kernels 1, 2 and 3 at the FLEXIBLEAUTOEXT chain's new shapes
    (``CkksParams.generate(n=2^14, mult_depth=2, dnum=2, extra_mod_bits=20)``:
    Q = 60/40/40 + 20 bits, P = 2 x 60, digits {q0, q1} and {q2, q3}):
    kernel 1 on the 20-bit limb, kernel 2 from the digit {q2, q3} and the
    ModDown onto the four Q limbs, kernel 3 at nd=2, LK=6 over 27 polys."""
    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.ckks.eval import _ks_decomp_consts
    from ppqsflhe_tpu_torch.ckks.params import CkksParams
    from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
    from ppqsflhe_tpu_torch.ops import cuda_ext
    from ppqsflhe_tpu_torch.ops.cuda_ks import ks_inner_product, ks_inner_product_plain
    from ppqsflhe_tpu_torch.ops.cuda_mxu_ntt import route

    params = CkksParams.generate(n=N_ROUND, mult_depth=2, scale_bits=40, dnum=2,
                                 extra_mod_bits=20)
    sch = CkksScheme(params, device=device)
    ctx, n = sch.ctx, params.n
    mq, L = ctx.moduli_qp, params.num_q
    ext = (L - 1,)
    nd = ctx.fntt.tabs[ext[0]].nd
    routes = [route(n, t.nd) for t in ctx.fntt.tabs]
    print(f"[flexext] N={n}, Q={[q.bit_length() for q in params.q_moduli]} bits, "
          f"P={[p.bit_length() for p in params.p_moduli]} bits, digits {ctx.digit_groups}; "
          f"digit counts {[t.nd for t in ctx.fntt.tabs]}, routes {routes}")
    if routes[ext[0]] != "fused":
        raise AssertionError(f"the 20-bit limb routes to {routes[ext[0]]}, not kernel 1")
    x = rand_residues([mq[ext[0]]], (2 * N_CTS,), n, gen, device)
    for fwd in (True, False):
        run = lambda: (ctx.ntt if fwd else ctx.intt)(x, ext)
        fused_case(cases, ctx.fntt, x, ext, fwd, False, run, 20,
                   f"the 20-bit limb q3 (nd={nd}) x {2 * N_CTS} polys, N=2^14")
    idx_ext = ctx.q_idx(L) + ctx.p_idx()
    groups, consts = _ks_decomp_consts(ctx, L)
    if tuple(groups[1]) != (2, 3):
        raise AssertionError(f"digit groups {groups}: the second is not {{q2, q3}}")
    todo = ((groups[1], tuple(i for i in idx_ext if i not in groups[1]), consts[1], (N_CTS,)),
            (ctx.p_idx(), ctx.q_idx(L), None, (2, N_CTS)))
    for src, dst, pre, lead in todo:
        e = ctx.extender(src, dst)
        xe = rand_residues([mq[i] for i in src], lead, n, gen, device)
        tag = "digit {q2, q3}, pre" if pre is not None else "ModDown"
        cases.check(f"base_extend (FLEXIBLEAUTOEXT, {len(src)}->{len(dst)} limbs, {tag}, "
                    f"{'x'.join(map(str, lead))} polys, N=2^14)", "base_extend", SRC_EXT, K2,
                    cuda_ext.fused_extend(xe, e, pre), e.extend(xe, pre),
                    lambda: cuda_ext.fused_extend(xe, e, pre), lambda: e.extend(xe, pre), 50,
                    ext_work(int(np.prod(lead)), len(src), len(dst), n))
    limbs = tuple(range(len(mq)))
    q, qinv, _ = ctx.limb_consts(limbs, device)
    sel = ctx.consts(("limb_map", limbs), lambda: limbs, device)
    ndg = len(ctx.digit_groups)
    dig = rand_residues(mq, (N_CTS, ndg), n, gen, device)
    key = rand_residues(mq, (ndg, 2), n, gen, device)
    args = (dig, key, sel, q, qinv)
    cases.check(f"ks_inner_product (FLEXIBLEAUTOEXT, nd={ndg}, LK={len(limbs)}, {N_CTS} polys, "
                f"N=2^14)", "ks_inner_product", SRC_KS, K3, ks_inner_product(*args),
                ks_inner_product_plain(*args), lambda: ks_inner_product(*args),
                lambda: ks_inner_product_plain(*args), 50,
                ks_work(N_CTS, ndg, len(limbs), n))
    torch.cuda.synchronize()


def openfhe_wire_round(device, card):
    """One changeCipherDomain and one aggregation on the OpenFHE cereal wire
    (``wire="openfhe"``) through the port's tools on the card, from two
    clients' GRU weights encrypted on that wire (client 2 with its secret
    key, shipped dense); every field parsed back as cereal-BINARY, the
    aggregate decrypted against the plaintext mean (< 1e-3)."""
    import base64
    import tempfile

    import numpy as np

    from ppqsflhe_tpu_torch.ckks import openfhe_emit
    from ppqsflhe_tpu_torch.ckks import serialize as ser
    from ppqsflhe_tpu_torch.fl import api

    dev = str(device)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        P = lambda name: os.path.join(tmp, name)
        rng = np.random.default_rng(SEED)
        want1, want2 = write_weights(P("w1.json"), rng), write_weights(P("w2.json"), rng)
        with open(os.path.join(REPO, "configs", "config_cc.json")) as f:
            api.gen_cc(json.load(f), P("cc.json"))
        cc = P("cc.json")
        for i in (1, 2):
            api.key_gen(cc, P(f"pk{i}"), P(f"sk{i}"), seed=SEED + 10 + i, device=dev)
        api.rekey_gen(cc, P("sk1"), P("pk2"), P("rk12"), seed=SEED + 13, device=dev)
        api.encrypt_weights(cc, P("pk1"), P("w1.json"), P("e1.json"), seed=SEED + 14,
                            wire="openfhe", device=dev)
        api.encrypt_weights(cc, P("sk2"), P("w2.json"), P("e2.json"), seed=SEED + 15,
                            wire="openfhe", device=dev)
        t1 = time.perf_counter()
        api.change_cipher_domain(cc, P("rk12"), P("e1.json"), P("e12.json"), wire="openfhe",
                                 device=dev)
        api.aggregate_encrypted_weights(cc, [P("e12.json"), P("e2.json")], P("agg.json"),
                                        wire="openfhe", device=dev)
        t2 = time.perf_counter()
        doc = ser.load_enc_doc(P("agg.json"))
        n_fields = 0
        for entry in doc["weights_summary"]:
            for field in [entry["mean"], entry["std_dev"]] + entry["values"]:
                rec = openfhe_emit.parse_ciphertext_binary(base64.b64decode(field))
                if rec["towers"].shape[0] != 2:
                    raise AssertionError("an aggregate field is not a 2-component ciphertext")
                n_fields += 1
        dec = api.decrypt_weights(cc, P("sk2"), P("agg.json"), P("dec.json"), device=dev)
        mx, rms = decrypt_err(dec, {k: (want1[k] + want2[k]) / 2 for k in want1})
        size = os.path.getsize(P("agg.json"))
    print(f"[openfhe wire] changeCipherDomain + aggregate of 2 x {n_fields} cereal-BINARY "
          f"ciphertexts in {(t2 - t1) * 1e3:.1f} ms (set-up {t1 - t0:.1f} s); the aggregate "
          f"({size:,} B) parsed back field by field; decrypt max err {mx:.3e}, RMS {rms:.3e} "
          f"(gate {ERR_GATE}) ({card})")
    if not (np.isfinite(mx) and mx < ERR_GATE):
        raise AssertionError(f"OpenFHE-wire aggregate: decrypt error {mx} over the gate")


def twins_phase(card, device):
    """The four bench twins on the card — the server round in all five
    schedules, the rotations, the NTT and key-switch benches (the second
    key switch on the FLEXIBLEAUTOEXT chain), the artifact sizes — and one
    OpenFHE-wire PRE round, after the kernel checks at the new shapes.
    Prints each twin's JSON line and the phase's seconds; returns the
    kernels' rows."""
    import torch

    from ppqsflhe_tpu_torch.bench import kernels, rotations, server_round, sizes

    t0 = time.perf_counter()
    cases = KernelCases(card)
    flexext_kernel_checks(cases, torch.Generator().manual_seed(SEED), device)
    t_checks = time.perf_counter() - t0
    lines = []

    def out(line):
        print(f"[twin json] {line}")
        lines.append(json.loads(line))

    reset_counts()
    secs = {}
    for name, run in (
            ("server_round", lambda: [server_round.bench(device, lazy=lazy, reps=TWIN_REPS,
                                                         out=out) for lazy in (4, 0, 1, 2, 3)]),
            ("rotations", lambda: rotations.bench(device, reps=TWIN_REPS, out=out)),
            ("kernels", lambda: kernels.bench(device, reps=TWIN_REPS, out=out)),
            ("sizes", lambda: sizes.bench(device, out=out)),
            ("openfhe wire", lambda: openfhe_wire_round(device, card))):
        t1 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t1
    launches = read_counts()
    print(f"[twins] kernel launches: { {k: v for k, v in launches.items() if v} }")
    missing = [k for k in ("mxu_ntt", "mxu_ntt_mont", "streamed_stage_a", "streamed_stage_b",
                           "base_extend", "ks_inner_product", "fourstep_ntt") if not launches[k]]
    if missing:
        raise AssertionError(f"the bench twins never launched {missing}")
    for r in lines:
        if r["metric"] == server_round.METRIC:
            print(f"[timing twins] server round lazy={r['lazy']}: {r['value']:.3f} ms/round "
                  f"marginal (vs_baseline {r['vs_baseline']:.1f}), device "
                  f"{show_us(r['device_ms'])} a round, host enqueue {r['enqueue_ms']:.3f} ms, "
                  f"decrypt err {r['err']:.2e} at {r['out_limbs']} limb(s) ({card})")
    print(f"[twins] phase 11: {time.perf_counter() - t0:.1f} s (kernel checks {t_checks:.1f} "
          f"s; " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()) + f") ({card})")
    return cases.take_launches(launches)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs a CUDA GPU")
    from ppqsflhe_tpu_torch.ops import cuda_lib

    device = torch.device("cuda", 0)
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    print(f"[card] {card}")
    print(f"[toolchain] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch.version.cuda {torch.version.cuda}")
    print("[toolchain] nvcc: " + sh([cuda_lib.nvcc(), "--version"]).splitlines()[-1])

    t0 = time.perf_counter()
    cuda_lib.library()
    print(f"[build] kernels built in {cuda_lib.build_seconds or 0.0:.1f} s "
          f"(load {time.perf_counter() - t0:.1f} s) -> {cuda_lib.build()}")

    kernels, world, outs = round_phase(card, device, args.profile)
    kernels += rotation_phase(card, device, args.profile)
    kernels += ntt_phase(card, device)
    kernels += round16_phase(card, device, args.profile)
    kernels += butterfly_phase(card, device, world, outs, args.profile)
    kernels += files_phase(card, device, args.profile)
    kernels += multikey_phase(card, device)
    kernels += threshold_phase(card, device)
    kernels += probe_phase(card, device)
    kernels += orchestrated_phase(card, device)
    kernels += twins_phase(card, device)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
