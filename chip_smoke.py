#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's main path — the server's encrypted-aggregation round of
``bench.py`` (2 clients × 27 ciphertexts at N=2^14, the
``CkksParams.generate(n=2^14, mult_depth=2, dnum=2)`` chain) — once in each
schedule (lazy-4 and full level), through ``ppqsflhe_tpu_torch``:

1. prints the card, its power limit and the toolchain; builds the kernels;
2. runs each hand-written kernel and its plain torch version on the same
   inputs at the round's shapes, requires bit-equal outputs, and times both
   with CUDA events;
3. generates keys and rekeys, encrypts 27 seeded uniform(-1, 1) vectors of
   8192 slots per client, resets the kernels' launch counters, runs the
   round in both schedules, requires every kernel of the path to have
   launched, and decrypts both outputs against the plaintext mean
   (max error < 1e-3, the bench.py gate);
4. times ms/round per schedule (median of 20 rounds after warm-up);
5. prints a JSON line of per-kernel results, the card line, and finally
   ``{"ok": true, "device": {...}}``.

Any failure raises (exit code ≠ 0). Needs one CUDA device and nvcc; it
refuses to run without them. Run from the repository root:

    python3 chip_smoke.py [--profile]

``--profile`` adds a torch.profiler table of device time per kernel for one
round of each schedule.
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

N = 1 << 14
N_CTS = 27           # ciphertexts per client (the reference payload's count)
ERR_GATE = 1e-3      # bench.py's correctness gate
SEED = 7             # keys, noise and payloads
ROUNDS = 20          # timed rounds per schedule


def sh(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 2):
    """Mean device milliseconds per call of ``fn`` (CUDA events)."""
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


def rand_residues(moduli, shape, gen, device):
    """Uniform residues int64[*shape, len(moduli), N] below each modulus."""
    import torch

    return torch.stack([torch.randint(0, q, tuple(shape) + (N,), generator=gen,
                                      dtype=torch.int64) for q in moduli],
                       dim=len(shape)).to(device)


def kernel_checks(sch, rk_mont, gen, device, card):
    """Each kernel against its plain version at the round's shapes."""
    import torch

    from ppqsflhe_tpu_torch.ops import cuda_ext, mxu_ntt
    from ppqsflhe_tpu_torch.ops.cuda_ks import ks_inner_product, ks_inner_product_plain

    ctx = sch.ctx
    mq = ctx.moduli_qp
    L, K = sch.params.num_q, sch.params.num_p
    results = []

    def record(name, source, replaces, got, want, fn, plain_fn, iters):
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(f"{name}: kernel differs from plain version in {bad} residues")
        err = (got - want).abs().max().item()
        ms = cuda_ms(fn, iters)
        plain_ms = cuda_ms(plain_fn, max(2, iters // 5))
        print(f"[kernel] {name}: bit-equal to plain, kernel {ms * 1e3:.1f} us, plain "
              f"{plain_ms * 1e3:.1f} us  ({card})")
        results.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms))

    # kernel 1: the 2-limb transforms of the lazy key switch (q0: nd=9,
    # q1: nd=6) over both components of 27 ciphertexts
    idx = (0, 1)
    x = rand_residues([mq[i] for i in idx], (2 * N_CTS,), gen, device)
    plain_ntt = lambda v: torch.stack(
        [mxu_ntt.mxu_ntt_limb(v[:, k], ctx.fntt.tabs[i]) for k, i in enumerate(idx)], dim=1)
    got = ctx.ntt(x, idx)
    record(f"mxu_ntt (forward, 2 limbs x {2 * N_CTS} polys)", "ppqsflhe_tpu_torch/csrc/mxu_ntt.cu",
           "ppqsflhe_tpu/ops/pallas_mxu_ntt.py:390", got, plain_ntt(x),
           lambda: ctx.ntt(x, idx), lambda: plain_ntt(x), 20)
    back = ctx.intt(got, idx)
    plain_back = torch.stack(
        [mxu_ntt.mxu_intt_limb(got[:, k], ctx.fntt.tabs[i]) for k, i in enumerate(idx)], dim=1)
    if not (torch.equal(back, plain_back) and torch.equal(back, x)):
        raise AssertionError("mxu_ntt inverse differs from plain version or input")

    # kernel 2: every base extension the two schedules run — at each PRE
    # level l ∈ {3, 2, 1}, each digit group's decompose+extend (its constant
    # folded in, over the 27 c1 polys) and the ModDown P → Q_l (no constant,
    # over both components of the 27 products)
    from ppqsflhe_tpu_torch.ckks.eval import _ks_decomp_consts

    for l in (L, L - 1, 1):
        idx_ext = ctx.q_idx(l) + ctx.p_idx()
        groups, consts = _ks_decomp_consts(ctx, l)
        cases = [(g, tuple(i for i in idx_ext if i not in g), pre, (N_CTS,))
                 for g, pre in zip(groups, consts)]
        cases.append((ctx.p_idx(), ctx.q_idx(l), None, (2, N_CTS)))
        for src, dst, pre, lead in cases:
            ext = ctx.extender(src, dst)
            xe = rand_residues([mq[i] for i in src], lead, gen, device)
            tag = "pre" if pre is not None else "ModDown"
            record(f"base_extend (l={l}, {len(src)}->{len(dst)} limbs, {tag}, "
                   f"{'x'.join(map(str, lead))} polys)",
                   "ppqsflhe_tpu_torch/csrc/base_ext.cu", "ppqsflhe_tpu/ops/pallas_ext.py:167",
                   cuda_ext.fused_extend(xe, ext, pre), ext.extend(xe, pre),
                   lambda: cuda_ext.fused_extend(xe, ext, pre), lambda: ext.extend(xe, pre), 50)

    # kernel 3: the full-level inner product, nd=2 digits over LK=5 limbs
    limbs = tuple(range(L + K))
    nd = len(ctx.digit_groups)
    q, qinv, _ = ctx.limb_consts(limbs, device)
    sel = ctx.consts(("limb_map", limbs), lambda: limbs, device)
    dig = rand_residues(mq, (N_CTS, nd), gen, device)
    args = (dig, rk_mont.data, sel, q, qinv)
    record(f"ks_inner_product (nd={nd}, LK={len(limbs)}, {N_CTS} polys)",
           "ppqsflhe_tpu_torch/csrc/ks_ip.cu", "ppqsflhe_tpu/ops/pallas_ks.py:127",
           ks_inner_product(*args), ks_inner_product_plain(*args),
           lambda: ks_inner_product(*args), lambda: ks_inner_product_plain(*args), 50)
    torch.cuda.synchronize()
    return results


def max_err(sch, sk, cts, want):
    """Max |decrypt - want| over every ciphertext of the batch and slot."""
    from ppqsflhe_tpu_torch.ckks.types import Ciphertext

    err = 0.0
    for i in range(cts.data.shape[0]):
        got = sch.decrypt(sk, Ciphertext(cts.data[i], cts.scale))
        err = max(err, float(abs(got - want[i]).max()))
    return err


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs a CUDA GPU")
    from ppqsflhe_tpu_torch.ckks import eval as ev
    from ppqsflhe_tpu_torch.ckks.params import CkksParams
    from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
    from ppqsflhe_tpu_torch.fl.api import server_round
    from ppqsflhe_tpu_torch.ops import cuda_ext, cuda_ks, cuda_lib, cuda_mxu_ntt

    device = torch.device("cuda", 0)
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    print(f"[card] {card}")
    print(f"[toolchain] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch.version.cuda {torch.version.cuda}")
    print("[toolchain] nvcc: " + sh([cuda_lib.nvcc(), "--version"]).splitlines()[-1])
    try:
        import triton
        print(f"[toolchain] triton {triton.__version__}")
    except ImportError:
        print("[toolchain] triton not installed")

    t0 = time.perf_counter()
    cuda_lib.library()
    print(f"[build] kernels built in {cuda_lib.build_seconds or 0.0:.1f} s "
          f"(load {time.perf_counter() - t0:.1f} s) -> {cuda_lib.build()}")

    t0 = time.perf_counter()
    params = CkksParams.generate(n=N, mult_depth=2, scale_bits=40, dnum=2)
    sch = CkksScheme(params, device=device)
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
    print(f"[setup] N={N}, Q={[q.bit_length() for q in params.q_moduli]} bits, "
          f"P={[p.bit_length() for p in params.p_moduli]} bits, dnum={params.dnum}; "
          f"keys, rekeys and 2x{N_CTS} encryptions in {time.perf_counter() - t0:.1f} s")

    kernels = kernel_checks(sch, rk12, gen, device, card)
    counters = {"mxu_ntt": cuda_mxu_ntt, "base_extend": cuda_ext,
                "ks_inner_product": cuda_ks}

    # the main path, once per schedule, with fresh launch counters
    want = (np.array(v1) + np.array(v2)) / 2
    for m in counters.values():
        m.launches = 0
    outs, per_sched = {}, {}
    for lazy in (4, 0):
        before = {k: m.launches for k, m in counters.items()}
        outs[lazy] = server_round(sch, ct1, ct2, rk12, rk21, lazy)
        torch.cuda.synchronize()
        per_sched[lazy] = {k: m.launches - before[k] for k, m in counters.items()}
    launches = {k: m.launches for k, m in counters.items()}
    for lazy, need in ((4, ("mxu_ntt", "base_extend")),
                       (0, ("mxu_ntt", "base_extend", "ks_inner_product"))):
        print(f"[round lazy={lazy}] kernel launches: {per_sched[lazy]}")
        missing = [k for k in need if per_sched[lazy][k] == 0]
        if missing:
            raise AssertionError(f"schedule lazy={lazy} never launched {missing}")
    for lazy in (4, 0):
        avg, back = outs[lazy]
        e2 = max_err(sch, sk2, avg, want)
        e1 = max_err(sch, sk1, back, want)
        print(f"[round lazy={lazy}] decrypt max err: average under sk2 {e2:.3e}, "
              f"re-encrypted under sk1 {e1:.3e} (gate {ERR_GATE}); output "
              f"{tuple(back.data.shape)} at {back.nlimbs} limb(s)")
        if not (np.isfinite(e1) and np.isfinite(e2) and max(e1, e2) < ERR_GATE):
            raise AssertionError(f"lazy={lazy}: decrypt error {max(e1, e2)} over the gate")

    # ms/round per schedule: median of per-round CUDA-event times
    for lazy in (4, 0):
        for _ in range(3):
            server_round(sch, ct1, ct2, rk12, rk21, lazy)
        times = []
        for _ in range(ROUNDS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            server_round(sch, ct1, ct2, rk12, rk21, lazy)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        print(f"[timing lazy={lazy}] server round {statistics.median(times):.3f} ms/round "
              f"(median of {len(times)}, min {min(times):.3f}, max {max(times):.3f}; "
              f"2x{N_CTS} ciphertexts, N={N}; {card})")

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        for lazy in (4, 0):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                server_round(sch, ct1, ct2, rk12, rk21, lazy)
                torch.cuda.synchronize()
            print(f"[profile lazy={lazy}]")
            print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))

    for k in kernels:
        k["launches"] = launches[k["name"].split()[0]]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
