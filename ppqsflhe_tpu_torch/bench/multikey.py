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
device time, the host's enqueue time and the device's idle share. The
round calls ``ckks.eval`` directly, so it runs eagerly (the scheme caches a
CUDA graph per operation). The JAX bench times the round jitted whole
(``bench_multikey.py:237``), so :class:`CompiledMultikeyRound` captures it
as one CUDA graph over static stacks and the 30 rekeys, held ``torch.equal``
to the eager round and timed the same way under ``compiled_*`` keys (None
on the CPU). Run on the card::

    python -m ppqsflhe_tpu_torch.bench.multikey [--lazy 4|0] [--seed S]

It prints one JSON line with the JAX bench's keys
(``"metric": "multikey_fl_rounds_per_sec"``; ``value`` is the eager round's)
plus the compiled round's keys and ``"card"``. A failed gate, or a compiled
round that differs from the eager one, raises after the line.
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
from ..utils import graphs, profiling
from . import timing
from .timing import card_line

N_CLIENTS = 16
# the stacked LSTM's Keras weight layout (ppqsflhe_tpu/train/lstm.py:27-36)
LSTM_SHAPES = ((7, 1200), (300, 1200), (1200,), (300, 1200), (300, 1200), (1200,), (300, 1),
               (1,))
ERR_GATE = 1e-3
COMPILED_KEYS = ("compiled_rounds_per_sec", "compiled_device_ms", "compiled_idle_share",
                 "compiled_capture_s", "compiled_equal")
# device kernels of the round, by symbol
KERNELS = {"kernel 1": "mxu_ntt_stage_kernel", "kernel 2": "base_extend_kernel",
           "kernel 3": "ks_ip_kernel"}


def params(n: int = 1 << 14) -> CkksParams:
    """The bench's chain: ``CkksParams.generate(n=2^14, mult_depth=2,
    scale_bits=40, dnum=2)``, four-step order."""
    return CkksParams.generate(n=n, mult_depth=2, scale_bits=40, dnum=2)


def payloads(seed: int, n_clients: int = N_CLIENTS, slots: int = 8192, shapes=LSTM_SHAPES):
    """Per client, the plaintext vectors of its encrypted-weights document
    in the LSTM layout (``shapes``): per layer [mean], [std_dev] and the
    values in slot-sized chunks, uniform(−1, 1) from
    ``numpy.random.default_rng(seed)``. Returns (vectors per client,
    parameter count)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_clients):
        vecs = []
        for shape in shapes:
            v = rng.uniform(-1, 1, math.prod(shape))
            vecs += [np.array([v.mean()]), np.array([v.std()])]
            vecs += [v[c * slots : (c + 1) * slots] for c in range(-(-v.size // slots))]
        out.append(vecs)
    return out, sum(math.prod(s) for s in shapes)


def encrypt_split(sch: CkksScheme, pks, vecs, gen: torch.Generator):
    """Each client's vectors encrypted under its key as one batch →
    (ciphertexts, seconds): the three parts of the encryptions timed apart,
    each synchronized on the card: ``encode`` (``make_plaintext``: the host
    encoding, its upload and the plaintext's NTT), ``draws`` (one sampler
    call of each kind over the batch) and ``body`` (the scheme's cached
    encryption on them)."""
    secs = dict.fromkeys(("encode", "draws", "body"), 0.0)
    sync = torch.cuda.synchronize if sch.device.type == "cuda" else (lambda: None)
    cts = []
    for pk, v in zip(pks, vecs):
        t0 = time.perf_counter()
        pt = sch.make_plaintext(v)
        sync()
        t1 = time.perf_counter()
        draws = rlwe.encrypt_draws(sch.ctx, gen, pt.data.shape[:-2], pt.data.device)
        sync()
        t2 = time.perf_counter()
        cts.append(sch.encrypt_drawn(pk, pt, draws))
        sync()
        t3 = time.perf_counter()
        for k, dt in zip(secs, (t1 - t0, t2 - t1, t3 - t2)):
            secs[k] += dt
    return cts, secs


def prep(sch: CkksScheme, vecs, gen: torch.Generator):
    """Keys for every client, the rekeys into the hub (the last client) and
    back in Montgomery form, and every client's vectors encrypted under its
    own key as one (C, B, 2, L, N) stack; the seconds of each step, the
    encryptions' also split as :func:`encrypt_split` times them."""
    t0 = time.perf_counter()
    keys = [sch.keygen(gen) for _ in vecs]
    t_keys = time.perf_counter() - t0
    hub = len(vecs) - 1
    sk_hub, pk_hub = keys[hub]
    rk_to = [ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk, pk_hub, gen)) for sk, _ in keys[:hub]]
    rk_from = [ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk_hub, pk, gen)) for _, pk in keys[:hub]]
    if sch.device.type == "cuda":
        torch.cuda.synchronize()
    t_rekeys = time.perf_counter() - t0 - t_keys
    cts, split = encrypt_split(sch, [pk for _, pk in keys], vecs, gen)
    stacks = Ciphertext(torch.stack([c.data for c in cts]), scale=cts[0].scale)
    del cts
    if stacks.data.is_cuda:
        torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0 - t_keys - t_rekeys
    return types.SimpleNamespace(sks=[k[0] for k in keys], pks=[k[1] for k in keys],
                                 stacks=stacks, rk_to=rk_to,
                                 rk_from=rk_from, seconds={"keygen": t_keys, "rekeys": t_rekeys,
                                                           "encrypt": t_enc, **split})


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
    ctx = sch.ctx
    with profiling.span("round"):
        acc = Ciphertext(stacks.data[C - 1], scale)
        for i in range(C - 1):
            pre = ev.re_encrypt(ctx, Ciphertext(stacks.data[i], scale), rk_to[i])
            with profiling.span("fedavg"):
                acc = ev.add(ctx, acc, pre)
        with profiling.span("fedavg"):
            if lazy >= 2 and (C & (C - 1)) == 0:
                avg = Ciphertext(acc.data, scale * C)          # ÷C is scale metadata
            else:
                avg = ev.mult_scalar(ctx, acc, 1.0 / C)
        if lazy >= 4 and avg.nlimbs > 1:
            avg = ev.level_reduce(ctx, avg, avg.nlimbs - 1)
        outs = torch.stack([ev.re_encrypt(ctx, avg, rk).data for rk in rk_from])
    return avg, Ciphertext(outs, avg.scale)


class CompiledMultikeyRound:
    """:func:`server_round` over static stacks of ``shape`` (C, B, 2, l_in,
    N) at ``scale`` as one CUDA graph, the counterpart of
    ``jax.jit(server_round)`` (``bench_multikey.py:237``): :data:`..utils.graphs.WARMUP`
    eager rounds on a side stream, then the capture. The graph reads the
    2(C−1) rekeys by address (kept here, in Montgomery form). A call copies
    the stacks in (skipped when they are the static stacks), replays and
    returns the graph's outputs, overwritten by the next call."""

    def __init__(self, sch: CkksScheme, rk_to, rk_from, lazy: int, shape, scale: float):
        device = torch.device(sch.device)
        if device.type != "cuda":
            raise RuntimeError(f"CompiledMultikeyRound captures a CUDA graph; the scheme is on "
                               f"{device} (run server_round there)")
        self.sch, self.lazy, self.scale = sch, lazy, float(scale)
        self.rk_to = [ev.ksk_to_mont(sch.ctx, k) for k in rk_to]
        self.rk_from = [ev.ksk_to_mont(sch.ctx, k) for k in rk_from]
        self.stacks = torch.zeros(tuple(shape), dtype=torch.int64, device=device)
        t0 = time.perf_counter()
        graphs.warm_up(self._round, device, graphs.WARMUP)
        torch.cuda.synchronize(device)
        self.graph = graphs.Graph(self._round, f"the multikey round ({tuple(shape)}, "
                                               f"lazy={lazy})")
        self.capture_s = time.perf_counter() - t0
        self.launches = self.graph.launches

    def _round(self):
        return server_round(self.sch, Ciphertext(self.stacks, self.scale), self.rk_to,
                            self.rk_from, self.lazy)

    def replay(self):
        """Run the graph on the static stacks as they stand → (average,
        outbound stack)."""
        return self.graph.replay()

    def __call__(self, stacks: Ciphertext):
        if stacks.scale != self.scale or stacks.data.shape != self.stacks.shape:
            raise ValueError(f"stacks {tuple(stacks.data.shape)} at scale {stacks.scale}; the "
                             f"graph was captured for {tuple(self.stacks.shape)} at scale "
                             f"{self.scale}")
        with profiling.span("round.call"):
            with profiling.span("round.load"):
                if stacks.data is not self.stacks:
                    self.stacks.copy_(stacks.data)
            with profiling.span("round.replay", device=False):
                return self.replay()


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


def measure_compiled(sch: CkksScheme, stacks: Ciphertext, rk_to, rk_from, lazy: int,
                     reps: int = 2) -> dict:
    """The compiled round: capture (seconds, warm-up included), one replay
    on ``stacks`` against the eager round (``equal``), then :func:`measure`'s
    numbers over replays (each first rewriting one residue of the static
    stacks)."""
    cr = CompiledMultikeyRound(sch, rk_to, rk_from, lazy, stacks.data.shape, stacks.scale)
    eager = server_round(sch, stacks, rk_to, rk_from, lazy)
    equal = all(torch.equal(a.data, b.data) and a.scale == b.scale
                for a, b in zip(eager, cr(stacks)))
    del eager
    return dict(measure_replays(cr, reps), equal=equal)


def measure_replays(cr: CompiledMultikeyRound, reps: int = 2) -> dict:
    """:func:`measure`'s numbers for the replays of ``cr`` (each first
    rewriting one residue of its static stacks, restored after), with its
    capture seconds."""
    m = timing.marginal_carried_ms(lambda: [c.data for c in cr.replay()], cr.stacks, 1, 3, reps)
    ms = m["ms"]
    dev, by = device_breakdown(cr.replay)
    return {"ms": ms, "rounds_per_sec": 1e3 / ms, "t1_ms": m["t_lo_ms"], "t3_ms": m["t_hi_ms"],
            "device_ms": dev, "by_kernel": by, "enqueue_ms": timing.enqueue_ms(cr.replay),
            "idle_share": None if dev is None else max(0.0, 1 - dev / ms),
            "capture_s": cr.capture_s}


def bench(device="cuda", lazy: int = 4, seed: int = 0, n: int = 1 << 14,
          clients: int = N_CLIENTS, shapes=LSTM_SHAPES, out=print) -> dict:
    """Set up, run the round once against the gate, time it eagerly and
    compiled (on the card), print the JSON line with ``out`` and return it;
    raises after printing when the gate fails or the compiled round
    differs. On the CPU nothing is timed (``value`` None)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    card = card_line() if on_card else None
    sch = CkksScheme(params(n), device=device)
    vecs, n_params = payloads(seed, clients, sch.encoder.slots, shapes)
    t0 = time.perf_counter()
    w = prep(sch, vecs, torch.Generator(device=device).manual_seed(seed))
    t_prep = time.perf_counter() - t0
    t0 = time.perf_counter()
    staged = stage(w.stacks, inbound_level(sch, lazy))
    if on_card:
        torch.cuda.synchronize()
    t_stage = time.perf_counter() - t0
    avg, outs = server_round(sch, staged, w.rk_to, w.rk_from, lazy)
    errs = check(sch, w, vecs, avg, outs)
    del avg, outs
    err = max(errs.values())
    m = (measure(sch, staged, w.rk_to, w.rk_from, lazy) if on_card
         else dict.fromkeys(("ms", "rounds_per_sec", "device_ms", "enqueue_ms", "idle_share")))
    c = measure_compiled(sch, staged, w.rk_to, w.rk_from, lazy) if on_card else {}
    compiled = {k: c.get(k.removeprefix("compiled_")) for k in COMPILED_KEYS}
    result = {
        "metric": "multikey_fl_rounds_per_sec", "value": m["rounds_per_sec"],
        "unit": "rounds/s", "clients": clients, "params": n_params,
        "round_seconds": None if m["ms"] is None else m["ms"] / 1e3,
        "staging_seconds": t_stage, "correct": bool(np.isfinite(err) and err < ERR_GATE),
        "err": err, "lazy": lazy, "prep_seconds": t_prep, "device_ms": m["device_ms"],
        "enqueue_ms": m["enqueue_ms"], "idle_share": m["idle_share"], **compiled, "card": card}
    out(json.dumps(result))
    if not result["correct"]:
        raise AssertionError(f"multikey lazy={lazy}: decrypt error {errs} over {ERR_GATE}")
    if compiled["compiled_equal"] is False:
        raise AssertionError(f"multikey lazy={lazy}: the compiled round differs from the eager "
                             "round")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lazy", type=int, choices=(4, 0), default=4,
                    help="the schedule: lazy-4 (default) or the full level")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("multikey bench: needs a CUDA GPU")
    bench("cuda", args.lazy, args.seed)


if __name__ == "__main__":
    main()
