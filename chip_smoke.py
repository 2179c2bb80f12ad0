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
  limbs, kernels 4+5 on the 60-bit ones, 2, and 3 at full level;
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
- **kernel 7**, the tensor-core / integer-chain overlap probe of
  ``probes/mxu_vpu_overlap.py`` at its shapes (K=64 cells, m=256, nd=6,
  c=256): µs/cell for its four orders, scan-marginal over chained launches.

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
extensions has no published rate, so their bound is the bytes). No PyTorch
call computes an NTT, base extension or key inner product mod q, so
``library_ms`` is null in those rows; the probe's mxu row carries the time
of ``torch._int_mm`` over the same cells (one call per cell).

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
K1, K2, K3 = ("ppqsflhe_tpu/ops/pallas_mxu_ntt.py:390", "ppqsflhe_tpu/ops/pallas_ext.py:167",
              "ppqsflhe_tpu/ops/pallas_ks.py:127")
K4, K5 = "ppqsflhe_tpu/ops/pallas_mxu_ntt.py:512", "ppqsflhe_tpu/ops/pallas_mxu_ntt.py:566"
K1B, K6 = "ppqsflhe_tpu/ops/pallas_mxu_ntt.py:347", "ppqsflhe_tpu/ops/pallas_ntt.py:207"
SRC_NTT = "ppqsflhe_tpu_torch/csrc/mxu_ntt.cu"
SRC_FS = "ppqsflhe_tpu_torch/csrc/fourstep_ntt.cu"
SRC_EXT = "ppqsflhe_tpu_torch/csrc/base_ext.cu"
SRC_KS = "ppqsflhe_tpu_torch/csrc/ks_ip.cu"
SRC_PROBE = "ppqsflhe_tpu_torch/csrc/overlap_probe.cu"
K7 = "probes/mxu_vpu_overlap.py:59"
# launch counter → (module under ppqsflhe_tpu_torch, attribute, kernel symbol)
COUNTERS = {
    "mxu_ntt": ("ops.cuda_mxu_ntt", "launches", "mxu_ntt_stage_kernel"),
    "mxu_ntt_mont": ("ops.cuda_mxu_ntt", "launches_mont", "mxu_ntt_stage_mont_kernel"),
    "mxu_stage_a": ("ops.cuda_mxu_ntt", "launches_stage_a", "mxu_stage_a_kernel"),
    "mxu_stage_b": ("ops.cuda_mxu_ntt", "launches_stage_b", "mxu_stage_b_kernel"),
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


def mxu_work(tabs, B, twiddle_bytes=16):
    """A whole digit-matmul transform of B polys over limbs with tables
    ``tabs``: x in and out, both stage matrices, the twiddle table."""
    nbytes = ops = 0
    for t in tabs:
        a, b = (t.nd * t.n1) ** 2, (t.nd * t.n2) ** 2
        nbytes += 16 * B * t.n + a + b + twiddle_bytes * t.n
        ops += 2 * B * (a * t.n2 + b * t.n1)
    return nbytes, ops


def stage_work(tabs, B, m, c, twiddle):
    """One streamed stage over an (m, c) block of B polys per limb."""
    nbytes = ops = 0
    for t in tabs:
        a = (t.nd * m) ** 2
        nbytes += 16 * B * m * c + a + (16 * m * c if twiddle else 0)
        ops += 2 * B * a * c
    return nbytes, ops


def butterfly_work(L, B, n1, n2):
    """A kernel-6 transform of B polys over L limbs: x in and out, two
    (value, companion) elementwise tables and the Pease stage tables."""
    stages = 16 * ((n1.bit_length() - 1) * n1 // 2 + (n2.bit_length() - 1) * n2 // 2)
    return L * (16 * B * n1 * n2 + 32 * n1 * n2 + stages), 0


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
              library_ms=None):
        """``work``: (bytes, int8 operations) of one call, for its bound;
        ``library_ms``: the time of one PyTorch call for the same function."""
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
              f"{work[1] / 1e9:.2f} G int8 ops) ({self.card})")
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
    from ppqsflhe_tpu_torch.ops import cuda_ext, mxu_ntt
    from ppqsflhe_tpu_torch.ops.cuda_ks import ks_inner_product, ks_inner_product_plain

    ctx, n = sch.ctx, sch.params.n
    mq = ctx.moduli_qp
    L, K = sch.params.num_q, sch.params.num_p

    # kernel 1: the 2-limb transforms of the lazy key switch (q0: nd=9,
    # q1: nd=6) over both components of 27 ciphertexts
    idx = (0, 1)
    x = rand_residues([mq[i] for i in idx], (2 * N_CTS,), n, gen, device)
    tabs = [ctx.fntt.tabs[i] for i in idx]
    plain_ntt = lambda v: torch.stack(
        [mxu_ntt.mxu_ntt_limb(v[:, k], t) for k, t in enumerate(tabs)], dim=1)
    got = ctx.ntt(x, idx)
    cases.check(f"mxu_ntt (forward, 2 limbs x {2 * N_CTS} polys, N=2^14)", "mxu_ntt", SRC_NTT,
                K1, got, plain_ntt(x), lambda: ctx.ntt(x, idx), lambda: plain_ntt(x), 20,
                mxu_work(tabs, 2 * N_CTS))
    back = ctx.intt(got, idx)
    plain_back = torch.stack(
        [mxu_ntt.mxu_intt_limb(got[:, k], t) for k, t in enumerate(tabs)], dim=1)
    if not (torch.equal(back, plain_back) and torch.equal(back, x)):
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
    torch.cuda.synchronize()


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
    outs, launches = drive_round("round", w.sch, w, {
        4: ("mxu_ntt", "base_extend"), 0: ("mxu_ntt", "base_extend", "ks_inner_product")})
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


def busy_line(tag, fn, wall_ms):
    """Device time by kernel for one call of ``fn`` against its wall time."""
    evs = device_events(fn)
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
    parts = ", ".join(f"{k} {v / 1e3:.3f}" for k, v in by.items() if v)
    print(f"[busy {tag}] device {busy / 1e3:.3f} ms of {wall_ms:.3f} ms wall "
          f"(idle {max(0.0, 1 - busy / 1e3 / wall_ms):.1%}): {parts}, other ops "
          f"{other / 1e3:.3f} ms, {len(evs)} device activities")


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
    from ppqsflhe_tpu_torch.ops import cuda_ext, cuda_mxu_ntt, mxu_ntt
    from ppqsflhe_tpu_torch.ops.cuda_ks import ks_inner_product, ks_inner_product_plain

    ctx, n = sch.ctx, sch.params.n
    fntt, tables = ctx.fntt, ctx.fntt.tables
    mq = ctx.moduli_qp
    L, K = sch.params.num_q, sch.params.num_p
    nd9 = [i for i, t in enumerate(fntt.tabs) if cuda_mxu_ntt.route(n, t.nd) == "big"]
    nd6 = [i for i, t in enumerate(fntt.tabs) if cuda_mxu_ntt.route(n, t.nd) == "fused"]
    print(f"[route N={n}] big (kernels 4+5): limbs {nd9}; fused (kernel 1): limbs {nd6}")
    if not nd9 or not nd6:
        raise AssertionError("the rotation chain must route limbs both ways at N=2^15")

    # kernels 4 and 5: the nd=9 limbs of the key switch's extended digit
    # (q0, p0, p1, forward, one poly) and of ModDown's iNTT (p0, p1 over both
    # components), each stage against its plain version, then the whole
    # transform through the big route against kernel 1 and the plain version
    for sel, lead, fwd in (([0] + list(ctx.p_idx()), (1,), True), (list(ctx.p_idx()), (2,), False)):
        sel = [i for i in sel if i in nd9]
        tag = f"{'forward' if fwd else 'inverse'}, limbs {sel} x {lead[0]} poly(s), N=2^15"
        m1, m2 = (fntt.n1, fntt.n2) if fwd else (fntt.n2, fntt.n1)
        first, second = ("a1", "a2") if fwd else ("a2i", "a1i")
        x = rand_residues([mq[i] for i in sel], lead, n, gen, device).reshape(
            lead[0], len(sel), m1, m2)
        mats, tw, info1, info2 = tables.device(device, sel, fwd)
        tabs = [fntt.tabs[i] for i in sel]
        pm1, pm2 = (tables.plain_mats(sel, nm, device) for nm in (first, second))
        twp = tables.twiddles(sel, fwd)
        ya = torch.empty_like(x)
        run_a = lambda: cuda_mxu_ntt.stage_a(x, ya, mats, info1, tw, m2)
        plain_a = lambda: mxu_ntt.stage_a(x, pm1, twp, tabs)
        cases.check(f"mxu_stage_a ({tag})", "mxu_stage_a", SRC_NTT, K4,
                    run_a().clone(), plain_a(), run_a, plain_a, 20,
                    stage_work(tabs, lead[0], m1, m2, True))
        zb = torch.empty((lead[0], len(sel), m2, m1), dtype=torch.int64, device=device)
        run_b = lambda: cuda_mxu_ntt.stage_b(ya, zb, mats, info2)
        plain_b = lambda: mxu_ntt.stage_b(ya, pm2, tabs)
        cases.check(f"mxu_stage_b ({tag})", "mxu_stage_b", SRC_NTT, K5,
                    run_b().clone(), plain_b(), run_b, plain_b, 20,
                    stage_work(tabs, lead[0], m2, m1, False))
        # stage A on one half of the columns, reading its slice of the table
        h = m2 // 2
        xh = x[..., h:].contiguous()
        got = cuda_mxu_ntt.stage_a(xh, torch.empty_like(xh), mats, info1, tw, m2, h)
        want = mxu_ntt.stage_a(xh, pm1, tuple(a[..., h:] for a in twp), tabs)
        if not torch.equal(got, want):
            raise AssertionError(f"mxu_stage_a on columns [{h}, {m2}) differs ({tag})")
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
    plain_ntt = lambda v: torch.stack(
        [mxu_ntt.mxu_ntt_limb(v[:, k], fntt.tabs[i]) for k, i in enumerate(idx)], dim=1)
    got = ctx.ntt(x, idx)
    cases.check(f"mxu_ntt (forward, limbs {list(idx)} x 2 polys, N=2^15)", "mxu_ntt", SRC_NTT,
                K1, got, plain_ntt(x), lambda: ctx.ntt(x, idx), lambda: plain_ntt(x), 20,
                mxu_work([fntt.tabs[i] for i in idx], 2))
    if not torch.equal(ctx.intt(got, idx), x):
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
    missing = [k for k in ("mxu_ntt", "mxu_stage_a", "mxu_stage_b", "base_extend",
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
    inputs, with a limb subset, and the A/B lines."""
    import torch

    from ppqsflhe_tpu_torch.ops import mxu_ntt
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
            fn = mxu_ntt.mxu_ntt_limb if fwd else mxu_ntt.mxu_intt_limb
            run = lambda: mx.fused(xs, fwd, mont, mont=True)
            plain = lambda: torch.stack([fn(xs[:, k], mx.tabs[i], True)
                                         for k, i in enumerate(mont)], dim=1)
            cases.check(f"mxu_ntt_mont ({'forward' if fwd else 'inverse'}, limbs {mont} x {B} "
                        f"polys, {tag})", "mxu_ntt_mont", SRC_NTT, K1B, run(), plain(), run,
                        plain, 10, mxu_work([mx.tabs[i] for i in mont], B, 8))
            ab_line(f"nd=6 {'forward' if fwd else 'inverse'}, limbs {mont} x {B} polys, {tag}",
                    run, lambda: mx.fused(xs, fwd, mont), ("kernel 1b (Montgomery twiddle)",
                                                           "kernel 1 (Shoup twiddle)"), card)
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
            N_BIG: ("mxu_ntt_mont", "mxu_stage_a", "mxu_stage_b", "fourstep_ntt")}
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
    from ppqsflhe_tpu_torch.ops import cuda_ext, cuda_mxu_ntt, mxu_ntt
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
        fn = mxu_ntt.mxu_ntt_limb if fwd else mxu_ntt.mxu_intt_limb
        run = lambda: (ctx.ntt if fwd else ctx.intt)(x, sel)
        plain = lambda: torch.stack([fn(x[:, k], fntt.tabs[i], True)
                                     for k, i in enumerate(sel)], dim=1)
        cases.check(f"mxu_ntt_mont ({'forward' if fwd else 'inverse'}, limbs {sel} x "
                    f"{lead[0]} polys, N=2^16)", "mxu_ntt_mont", SRC_NTT, K1B, run(), plain(),
                    run, plain, 5, mxu_work([fntt.tabs[i] for i in sel], lead[0], 8))

    # kernels 4 and 5: the extended digit's forward NTT on the 60-bit limbs
    sel = [i for i in big if i not in ctx.q_idx(1)] or big
    tables, tabs = fntt.tables, [fntt.tabs[i] for i in sel]
    xb = rand_residues([mq[i] for i in sel], (N_CTS,), n, gen, device).reshape(
        N_CTS, len(sel), fntt.n1, fntt.n2)
    mats, tw, info1, info2 = tables.device(device, sel, True)
    ya = torch.empty_like(xb)
    pm1, pm2 = (tables.plain_mats(sel, nm, device) for nm in ("a1", "a2"))
    twp = tables.twiddles(sel, True)
    run_a = lambda: cuda_mxu_ntt.stage_a(xb, ya, mats, info1, tw, fntt.n2)
    plain_a = lambda: mxu_ntt.stage_a(xb, pm1, twp, tabs)
    tag = f"forward, limbs {sel} x {N_CTS} polys, N=2^16"
    cases.check(f"mxu_stage_a ({tag})", "mxu_stage_a", SRC_NTT, K4, run_a().clone(), plain_a(),
                run_a, plain_a, 5, stage_work(tabs, N_CTS, fntt.n1, fntt.n2, True))
    zb = torch.empty((N_CTS, len(sel), fntt.n2, fntt.n1), dtype=torch.int64, device=device)
    run_b = lambda: cuda_mxu_ntt.stage_b(ya, zb, mats, info2)
    plain_b = lambda: mxu_ntt.stage_b(ya, pm2, tabs)
    cases.check(f"mxu_stage_b ({tag})", "mxu_stage_b", SRC_NTT, K5, run_b().clone(), plain_b(),
                run_b, plain_b, 5, stage_work(tabs, N_CTS, fntt.n2, fntt.n1, False))

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
    torch.cuda.synchronize()


def round16_phase(card, device, profile_on):
    """The server round at N=2^16 (8192 slots): set-up, kernel checks, main
    path in both schedules, decrypt, ms/round."""
    w = round_world(N_BIG, device, slots=SLOTS)
    cases = KernelCases(card)
    round16_kernel_checks(cases, w.sch, w.rk12, w.gen, device)
    ntt_kernels = ("mxu_ntt_mont", "mxu_stage_a", "mxu_stage_b", "base_extend")
    _, launches = drive_round("round N=2^16", w.sch, w, {
        4: ntt_kernels, 0: ntt_kernels + ("ks_inner_product",)})
    time_round("round N=2^16", w.sch, w, card, profile_on)
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

    digit_matmul = ("mxu_ntt", "mxu_ntt_mont", "mxu_stage_a", "mxu_stage_b")
    outs, launches = drive_round("butterfly round", sch, w, {
        4: ("fourstep_ntt", "base_extend"),
        0: ("fourstep_ntt", "base_extend", "ks_inner_product")}, absent=digit_matmul)
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
    from ppqsflhe_tpu_torch.ops import cuda_ext, mxu_ntt
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
        tabs = [ctx.fntt.tabs[i] for i in idx]
        plain = lambda: torch.stack([mxu_ntt.mxu_intt_limb(x[:, k], t)
                                     for k, t in enumerate(tabs)], dim=1)
        cases.check(f"mxu_ntt ({tag}, inverse, 3 limbs x {N_CTS} polys, N=2^14)", "mxu_ntt",
                    SRC_NTT, K1, ctx.intt(x, idx), plain(), lambda: ctx.intt(x, idx), plain, 20,
                    mxu_work(tabs, N_CTS))
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
            ntt_kernels = ("mxu_ntt", "mxu_ntt_mont", "mxu_stage_a", "mxu_stage_b",
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
# Path 7: kernel 7, the tensor-core / integer-chain overlap probe
# ---------------------------------------------------------------------------

def probe_work(kind, x8, m):
    """(bytes, int8 operations) of one probe launch over all K cells."""
    K, W, c = x8.shape
    out = 4 * K * m * c
    if kind == "vpu":
        return K * m * c + out, 0
    return K * W * c + m * W + out, 2 * K * m * W * c


def probe_phase(card, device):
    """Kernel 7 at the TPU probe's shapes: bit-equal to its plain version
    for the four kinds with carry 0 and non-zero, torch._int_mm as the mxu
    kind's library call, then µs/cell scan-marginally (the main path)."""
    import torch

    from ppqsflhe_tpu_torch.probes import mxu_vpu_overlap as pr

    x8, a = pr.inputs(device, seed=0)
    m = pr.M
    cells = [x8[k] for k in range(x8.shape[0])]
    am = a[:m].contiguous()
    lib = lambda: [torch._int_mm(am, xk) for xk in cells]
    lib_dev = device_ms(lib, 3)
    lib_wall = cuda_ms(lib, 3)
    print(f"[probe] library: {len(cells)} torch._int_mm calls (one per cell): device "
          f"{show_us(lib_dev)}, wall {lib_wall * 1e3:.1f} us per set ({card})")
    want_mxu = torch.stack([c.to(torch.int64) & 0xFFFFFFFF for c in lib()])
    cases = KernelCases(card)
    crafted = torch.tensor([[[0x1A5]]], dtype=torch.int32, device=device)   # carry -91
    for kind in pr.KINDS:
        got = pr.probe(kind, x8, a, None, m)
        cases.check(f"overlap_probe ({kind}, K={x8.shape[0]}, m={m}, nd={pr.ND}, c={pr.C})",
                    "overlap_probe", SRC_PROBE, K7, got, pr.probe_plain(kind, x8, a, None, m),
                    lambda: pr.probe(kind, x8, a, None, m),
                    lambda: pr.probe_plain(kind, x8, a, None, m), 20, probe_work(kind, x8, m),
                    library_ms=(lib_dev or lib_wall) if kind == "mxu" else None)
        for prev in (got, crafted):       # a chained carry and a non-zero one
            if not torch.equal(pr.probe(kind, x8, a, prev, m),
                               pr.probe_plain(kind, x8, a, prev, m)):
                raise AssertionError(f"overlap_probe {kind}: differs from plain with carry "
                                     f"{pr.carry_byte(prev)}")
        if kind == "mxu" and not torch.equal(got.to(torch.int64) & 0xFFFFFFFF, want_mxu):
            raise AssertionError("overlap_probe mxu differs from torch._int_mm")
    print(f"[probe] kernel 7 bit-equal to its plain version for {list(pr.KINDS)} with carry 0 "
          f"and {pr.carry_byte(crafted)}; mxu = torch._int_mm per cell")
    torch.cuda.synchronize()

    reset_counts()
    us = pr.measure(x8, a, m)
    launches = read_counts()
    if launches["overlap_probe"] == 0:
        raise AssertionError("the probe never launched kernel 7")
    print(f"[probe] us/cell (scan-marginal over R={pr.R_LO} and R={pr.R_HI} chained launches, "
          f"K={x8.shape[0]} cells, one CTA each): "
          + ", ".join(f"{k} {v:.3f}" for k, v in us.items()) + f" ({card})")
    lo, hi = max(us["mxu"], us["vpu"]), us["mxu"] + us["vpu"]
    print(f"[probe] inter {us['inter']:.3f} vs max(mxu, vpu) {lo:.3f} and mxu+vpu {hi:.3f}: "
          f"{(hi - us['inter']) / max(hi - lo, 1e-9):.0%} of the possible overlap; serial "
          f"{us['serial']:.3f}")
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
    kernels += probe_phase(card, device)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
