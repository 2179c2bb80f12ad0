"""The multikey FL round on one GPU: the twin of ``bench_multikey.py``
(``BASELINE.json`` config 5, the rebuild target "encrypted-aggregation
rounds/sec").

16 clients each hold the stacked-LSTM export's weights (1,091,101 values:
138 value ciphertexts and 16 mean / std-dev ciphertexts at 8192 slots, 154
in all) encrypted under their own keys. The server's round:

1. PRE clients 0 … 14 into the hub's domain (client 15): per client one
   batched ``keyswitch`` of the 154 c1 polys plus a modadd, summed mod q;
2. FedAvg ÷16: free as scale metadata when lazy ≥ 2 and C is a power of
   two, else ``mult_scalar(1/C)`` + rescale;
3. under lazy-4, a free LevelReduce to one limb;
4. PRE the average back to each of the 15 clients.

The payloads are numpy-seeded uniform(−1, 1) values in the export's layout
(``ppqsflhe_tpu/train/lstm.py:27-36``), so nothing is downloaded or
trained. Keys, rekeys (Montgomery form, once) and the 2,464 encryptions are
made on the card; everything stays there (≈1.3 GB of stacks at the lazy
level, 1.9 GB at full level). :func:`measure` times the round as the JAX
bench does, the marginal cost between chained round counts ((t3 − t1)/2,
CUDA events, a data-dependent carry between rounds), beside the profiler's
device time, the host's enqueue time and the device's idle share. Run on
the card::

    python -m ppqsflhe_tpu_torch.bench.multikey [--lazy 4|0] [--seed S]

It prints one JSON line with the JAX bench's keys
(``"metric": "multikey_fl_rounds_per_sec"``) plus ``"card"``.
"""

from __future__ import annotations

import argparse
import json
import math
import time
import types

import numpy as np
import torch

from ..ckks import eval as ev
from ..ckks import rlwe
from ..ckks.params import CkksParams
from ..ckks.scheme import CkksScheme
from ..ckks.types import Ciphertext
from . import timing
from .timing import card_line

N_CLIENTS = 16
# the stacked LSTM's Keras weight layout (ppqsflhe_tpu/train/lstm.py:27-36)
LSTM_SHAPES = ((7, 1200), (300, 1200), (1200,), (300, 1200), (300, 1200), (1200,), (300, 1),
               (1,))
ERR_GATE = 1e-3
# device kernels of the round, by symbol
KERNELS = {"kernel 1": "mxu_ntt_stage_kernel", "kernel 2": "base_extend_kernel",
           "kernel 3": "ks_ip_kernel"}


def params() -> CkksParams:
    """The bench's chain: ``CkksParams.generate(n=2^14, mult_depth=2,
    scale_bits=40, dnum=2)``, four-step order."""
    return CkksParams.generate(n=1 << 14, mult_depth=2, scale_bits=40, dnum=2)


def payloads(seed: int, n_clients: int = N_CLIENTS, slots: int = 8192):
    """Per client, the plaintext vectors of its encrypted-weights document
    in the LSTM layout: per layer [mean], [std_dev] and the values in
    slot-sized chunks, uniform(−1, 1) from ``numpy.random.default_rng(seed)``.
    Returns (vectors per client, parameter count)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_clients):
        vecs = []
        for shape in LSTM_SHAPES:
            v = rng.uniform(-1, 1, math.prod(shape))
            vecs += [np.array([v.mean()]), np.array([v.std()])]
            vecs += [v[c * slots : (c + 1) * slots] for c in range(-(-v.size // slots))]
        out.append(vecs)
    return out, sum(math.prod(s) for s in LSTM_SHAPES)


def prep(sch: CkksScheme, vecs, gen: torch.Generator):
    """Keys for every client, the rekeys into the hub (the last client) and
    back in Montgomery form, and every client's vectors encrypted under its
    own key as one (C, B, 2, L, N) stack; the seconds of each step."""
    t0 = time.perf_counter()
    keys = [sch.keygen(gen) for _ in vecs]
    t_keys = time.perf_counter() - t0
    hub = len(vecs) - 1
    sk_hub, pk_hub = keys[hub]
    rk_to = [ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk, pk_hub, gen)) for sk, _ in keys[:hub]]
    rk_from = [ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk_hub, pk, gen)) for _, pk in keys[:hub]]
    t_rekeys = time.perf_counter() - t0 - t_keys
    cts = [sch.encrypt_values(pk, v, gen) for (_, pk), v in zip(keys, vecs)]
    stacks = Ciphertext(torch.stack([c.data for c in cts]), scale=cts[0].scale)
    del cts
    if stacks.data.is_cuda:
        torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0 - t_keys - t_rekeys
    return types.SimpleNamespace(sks=[k[0] for k in keys], stacks=stacks, rk_to=rk_to,
                                 rk_from=rk_from, seconds={"keygen": t_keys, "rekeys": t_rekeys,
                                                           "encrypt": t_enc})


def inbound_level(sch: CkksScheme, lazy: int) -> int:
    """The level of the inbound PREs: one limb below full under a lazy
    schedule (the LevelReduce on entry), full otherwise."""
    L = sch.params.num_q
    return max(1, L - 1) if lazy else L


def stage(stacks: Ciphertext, l_in: int) -> Ciphertext:
    """The stacks at the inbound level, contiguous: made once, outside the
    timed rounds (the JAX bench slices its host stacks the same way)."""
    return Ciphertext(stacks.data[..., :l_in, :].contiguous(), scale=stacks.scale)


def server_round(sch: CkksScheme, stacks: Ciphertext, rk_to, rk_from, lazy: int = 4):
    """The C-client round (``bench_multikey.py:194-234``) on ``stacks``
    (C, B, 2, l_in, N), client C−1 the hub: returns (the average in the
    hub's domain, (C−1, B, 2, l', N) of it re-encrypted to clients 0 … C−2)."""
    C = stacks.data.shape[0]
    scale = stacks.scale
    acc = Ciphertext(stacks.data[C - 1], scale)
    for i in range(C - 1):
        acc = ev.add(sch.ctx, acc, sch.re_encrypt(Ciphertext(stacks.data[i], scale), rk_to[i]))
    if lazy >= 2 and (C & (C - 1)) == 0:
        avg = Ciphertext(acc.data, scale * C)          # ÷C is scale metadata
    else:
        avg = sch.mult_scalar(acc, 1.0 / C)
    if lazy >= 4 and avg.nlimbs > 1:
        avg = ev.level_reduce(sch.ctx, avg, avg.nlimbs - 1)
    outs = torch.stack([sch.re_encrypt(avg, rk).data for rk in rk_from])
    return avg, Ciphertext(outs, avg.scale)


def slot_diffs(sch: CkksScheme, coeffs: torch.Tensor, cts: Ciphertext, want) -> np.ndarray:
    """Decoded − want over every ciphertext of the batch (its coefficient
    residues ``coeffs``) and every slot, ``want`` zero-padded to the slot
    count: one flat array."""
    diffs = []
    for c, w in zip(coeffs.cpu(), want):
        got = rlwe.decode_coeffs(sch.ctx, c, cts, sch.encoder)
        full = np.zeros(got.size)
        full[: len(w)] = w
        diffs.append(got - full)
    return np.concatenate(diffs)


def decrypt_err(sch: CkksScheme, sk, cts: Ciphertext, want) -> float:
    """Max |decrypt − want| over every ciphertext of the batch and slot."""
    coeffs = rlwe.decrypt_to_coeffs(sch.ctx, sk.s_eval, cts)
    return float(np.abs(slot_diffs(sch, coeffs, cts, want)).max())


def check(sch: CkksScheme, w, vecs, avg: Ciphertext, outs: Ciphertext) -> dict:
    """Decrypt errors: the whole average under the hub's key against the
    plaintext mean of the payloads, and the outbound ciphertexts of clients
    0 and C−2 under their own keys."""
    mean = [np.mean([v[k] for v in vecs], axis=0) for k in range(len(vecs[0]))]
    last = outs.data.shape[0] - 1
    return {"hub": decrypt_err(sch, w.sks[-1], avg, mean),
            "client 0": decrypt_err(sch, w.sks[0], Ciphertext(outs.data[0], outs.scale), mean),
            f"client {last}": decrypt_err(sch, w.sks[last],
                                          Ciphertext(outs.data[last], outs.scale), mean)}


def device_breakdown(fn) -> tuple:
    """(device ms, {kernel: ms}) of one call of ``fn`` under torch.profiler;
    (None, {}) when the profile holds no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by = dict.fromkeys(list(KERNELS) + ["torch elementwise"], 0.0)
    total = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        total += us
        key = next((k for k, sym in KERNELS.items() if sym in e.name), "torch elementwise")
        by[key] += us / 1e3
    return (total / 1e3 if total else None), by


def measure(sch: CkksScheme, stacks: Ciphertext, rk_to, rk_from, lazy: int,
            reps: int = 2) -> dict:
    """ms per round as the marginal cost between 1 and 3 chained rounds
    ((t3 − t1)/2, the best of ``reps`` after a warm-up each; each round
    rewrites one residue of the stack from the previous round's checksum),
    rounds/s, the profiler's device ms of one round by kernel, the host's
    enqueue ms (median of 5, the device drained before each) and the idle
    share."""
    work = stacks.data.clone()
    run = lambda: server_round(sch, Ciphertext(work, stacks.scale), rk_to, rk_from, lazy)
    m = timing.marginal_carried_ms(lambda: [c.data for c in run()], work, 1, 3, reps)
    ms = m["ms"]
    dev, by = device_breakdown(run)
    return {"ms": ms, "rounds_per_sec": 1e3 / ms, "t1_ms": m["t_lo_ms"], "t3_ms": m["t_hi_ms"],
            "device_ms": dev, "by_kernel": by, "enqueue_ms": timing.enqueue_ms(run),
            "idle_share": None if dev is None else max(0.0, 1 - dev / ms)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lazy", type=int, choices=(4, 0), default=4,
                    help="the schedule: lazy-4 (default) or the full level")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("multikey bench: needs a CUDA GPU")
    card = card_line()
    sch = CkksScheme(params(), device="cuda")
    vecs, n_params = payloads(args.seed, N_CLIENTS, sch.encoder.slots)
    t0 = time.perf_counter()
    w = prep(sch, vecs, torch.Generator(device="cuda").manual_seed(args.seed))
    t_prep = time.perf_counter() - t0
    t0 = time.perf_counter()
    staged = stage(w.stacks, inbound_level(sch, args.lazy))
    torch.cuda.synchronize()
    t_stage = time.perf_counter() - t0
    avg, outs = server_round(sch, staged, w.rk_to, w.rk_from, args.lazy)
    errs = check(sch, w, vecs, avg, outs)
    m = measure(sch, staged, w.rk_to, w.rk_from, args.lazy)
    err = max(errs.values())
    print(json.dumps({
        "metric": "multikey_fl_rounds_per_sec", "value": m["rounds_per_sec"],
        "unit": "rounds/s", "clients": N_CLIENTS, "params": n_params,
        "round_seconds": m["ms"] / 1e3, "staging_seconds": t_stage,
        "correct": bool(np.isfinite(err) and err < ERR_GATE), "err": err,
        "lazy": args.lazy, "prep_seconds": t_prep, "device_ms": m["device_ms"],
        "enqueue_ms": m["enqueue_ms"], "idle_share": m["idle_share"], "card": card}))


if __name__ == "__main__":
    main()
