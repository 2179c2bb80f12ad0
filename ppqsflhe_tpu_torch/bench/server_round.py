"""The server's encrypted-aggregation round on one GPU: the twin of
``bench.py``.

Two clients each encrypt the reference payload's 27 vectors (here numpy
``uniform(−1, 1)`` at 8192 slots from seed 0, ``bench.py:52-67``, as the
JAX bench does without the reference's weights) at N=2^14 on
``CkksParams.generate(n=2^14, mult_depth=2, scale_bits=40, dnum=2)``
(Q = 60/40/40 bits, P = 2 × 60). The timed unit is ``fl.api.server_round``
over the two stacks: PRE client 1 → 2, FedAvg, PRE back to client 1, in the
schedule ``PPQSFLHE_BENCH_LAZY`` names (0 … 4, default 4;
``bench.py:178-222``). ``PPQSFLHE_BENCH_BACKEND`` (``fourstep`` or
``radix2``) and ``PPQSFLHE_BENCH_IMPL`` (a JAX ``ntt_impl`` name, mapped as
:mod:`..convert` maps it) pick the NTT, as ``bench.py:37-40`` reads them.
Keys, Montgomery-form rekeys and the encryptions are made on the card.

The round is timed as the marginal cost between 20 and 60 chained rounds
(:mod:`.timing`), beside one round's device time, the host's enqueue time
and the idle share on stderr: at N=2^14 the eager round is host-bound, so
the number measures the host. The gate (``bench.py:283``): the average
decrypts under client 2's key, and its re-encryption under client 1's, to
the payload within 1e-3 in every slot. A failed gate raises after the JSON
line is printed. Run on the card::

    python -m ppqsflhe_tpu_torch.bench.server_round

It prints one JSON line with ``bench.py``'s keys
(``"metric": "server_encrypted_aggregation_ms_per_round"``, ``value``,
``unit``, ``vs_baseline``) plus ``"card"`` and the timing's parts.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import types

import numpy as np
import torch

from ..ckks import eval as ev
from ..ckks.params import CkksParams
from ..ckks.scheme import CkksScheme
from ..ckks.types import Ciphertext
from ..fl.api import LAZY_MODES, server_round
from . import timing
from .multikey import decrypt_err
from .timing import card_line

N = 1 << 14
N_CTS = 27
BASELINE_SERVER_CRYPTO_MS = 8000.0     # the reference's window (bench.py:36)
R_LO, R_HI = 20, 60
ERR_GATE = 1e-3
METRIC = "server_encrypted_aggregation_ms_per_round"


def settings(env=os.environ) -> tuple:
    """(backend, implementation, lazy) from the environment, with
    ``bench.py``'s defaults."""
    lazy = int(env.get("PPQSFLHE_BENCH_LAZY", "4") or 0)
    if lazy not in LAZY_MODES:
        raise ValueError(f"PPQSFLHE_BENCH_LAZY={lazy}: one of {LAZY_MODES}")
    return (env.get("PPQSFLHE_BENCH_BACKEND", "fourstep"),
            env.get("PPQSFLHE_BENCH_IMPL", "pallas_mxu"), lazy)


def params(backend: str = "fourstep", impl: str = "pallas_mxu", n: int = N) -> CkksParams:
    return CkksParams.generate(n=n, mult_depth=2, scale_bits=40, dnum=2, ntt_backend=backend,
                               ntt_impl=impl)


def payload(slots: int, count: int = N_CTS, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, slots) for _ in range(count)]


def world(sch: CkksScheme, vecs, seed: int = 7):
    """Both clients' keys, the rekeys 1 → 2 and 2 → 1 in Montgomery form, and
    each client's encryption of ``vecs`` as one (B, 2, L, N) stack; made on
    the scheme's device from one seeded generator."""
    gen = torch.Generator(device=sch.device).manual_seed(seed)
    sk1, pk1 = sch.keygen(gen)
    sk2, pk2 = sch.keygen(gen)
    rk12 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk1, pk2, gen))
    rk21 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk2, pk1, gen))
    return types.SimpleNamespace(sk1=sk1, sk2=sk2, rk12=rk12, rk21=rk21,
                                 ct1=sch.encrypt_values(pk1, vecs, gen),
                                 ct2=sch.encrypt_values(pk2, vecs, gen))


def check(sch: CkksScheme, w, vecs, avg: Ciphertext, back: Ciphertext) -> dict:
    """Decrypt errors of the round's outputs against the payload (both
    clients encrypt the same vectors, so FedAvg gives them back)."""
    return {"average under sk2": decrypt_err(sch, w.sk2, avg, vecs),
            "re-encrypted under sk1": decrypt_err(sch, w.sk1, back, vecs)}


def measure(sch: CkksScheme, w, lazy: int, card: str, reps: int = 3) -> dict:
    """The marginal ms of a round between 20 and 60 chained rounds (each rewrites one residue of client 1's stack from the previous
    round's checksum), then one round's device ms, enqueue ms and idle
    share (stderr)."""
    work = w.ct1.data.clone()
    unit = lambda: server_round(sch, Ciphertext(work, w.ct1.scale), w.ct2, w.rk12, w.rk21,
                                lazy)
    outs = lambda: [c.data for c in unit()]
    m = timing.marginal_carried_ms(outs, work, R_LO, R_HI, reps)
    m.update(timing.unit_report(f"server_round lazy={lazy}", unit, m["ms"], card))
    return m


def bench(device="cuda", backend: str = "fourstep", impl: str = "pallas_mxu", lazy: int = 4,
          n: int = N, count: int = N_CTS, reps: int = 3, out=print) -> dict:
    """Set up, run the round once against the gate, time it (on the card),
    print the JSON line with ``out`` and return it; raises after printing
    when the gate fails. On the CPU nothing is timed (``value`` None)."""
    device = torch.device(device)
    card = card_line() if device.type == "cuda" else None
    t0 = time.perf_counter()
    sch = CkksScheme(params(backend, impl, n), device=device)
    vecs = payload(sch.encoder.slots, count)
    w = world(sch, vecs)
    avg, back = server_round(sch, w.ct1, w.ct2, w.rk12, w.rk21, lazy)
    errs = check(sch, w, vecs, avg, back)
    t_setup = time.perf_counter() - t0
    err = max(errs.values())
    correct = bool(np.isfinite(err) and err < ERR_GATE)
    m = measure(sch, w, lazy, card, reps) if device.type == "cuda" else {"ms": None}
    ms = m["ms"]
    result = {"metric": METRIC, "value": ms, "unit": "ms",
              "vs_baseline": None if ms is None else BASELINE_SERVER_CRYPTO_MS / ms,
              "lazy": lazy, "backend": backend, "impl": impl, "n": n, "ciphertexts": count,
              "correct": correct, "err": err, "out_scale": back.scale,
              "out_limbs": back.nlimbs, "setup_seconds": t_setup,
              **{k: v for k, v in m.items() if k != "ms"}, "card": card}
    out(json.dumps(result))
    if not correct:
        raise AssertionError(f"server round lazy={lazy}: decrypt error {errs} over {ERR_GATE}")
    return result


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("server_round bench: needs a CUDA GPU")
    backend, impl, lazy = settings()
    bench("cuda", backend, impl, lazy)


if __name__ == "__main__":
    main()
