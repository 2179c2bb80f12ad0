"""Galois rotations and hoisted key switching at N=2^15 on one GPU: the twin
of ``bench_rotations.py`` (``BASELINE.json`` config 3).

One ciphertext of ``linspace(−1, 1)`` over the slots on
``CkksParams.generate(n=2^15, mult_depth=2, scale_bits=40, dnum=2)``
(``PPQSFLHE_BENCH_IMPL`` picks the four-step implementation by its JAX name,
default ``xla``, mapped as :mod:`..convert` maps it), rotated by R=8 rotations
{1, 2, 4, …, 128} with Montgomery-form keys, three ways:

- plain: R independent ``rotate`` calls (R full key switches);
- hoisted: one decompose+extend shared by all R (``rotate_hoisted``);
- rotation sum: Σ_r rotate(ct, r) with one deferred ModDown
  (``rotate_sum_hoisted``).

Each is timed as the marginal cost between 12 and 36 chained passes
(:mod:`.timing`), reported in µs per rotation, beside one pass's device
time, the host's enqueue time and the idle share on stderr. Gates
(``bench_rotations.py:227-260``): the hoisted rotations decrypt to the
rolled vector within 1e-3 (first 64 slots), the plain ones are bit-equal to
them, and the sum decrypts within 1e-2. A failed gate raises after the JSON
line is printed. Run on the card::

    python -m ppqsflhe_tpu_torch.bench.rotations

It prints one JSON line with ``bench_rotations.py``'s keys
(``"metric": "hoisted_rotation_us_per_rotation_n32768"``, …) plus ``"card"``.
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
from . import timing
from .timing import card_line

N = 1 << 15
ROTS = [1, 2, 4, 8, 16, 32, 64, 128]
R_LO, R_HI = 12, 36
ERR_GATE, SUM_GATE = 1e-3, 1e-2
CHECK_SLOTS = 64


def params(n: int = N, impl: str | None = None) -> CkksParams:
    impl = impl or os.environ.get("PPQSFLHE_BENCH_IMPL", "xla")
    return CkksParams.generate(n=n, mult_depth=2, scale_bits=40, dnum=2, ntt_backend="fourstep",
                               ntt_impl=impl)


def world(sch: CkksScheme, rots=ROTS, seed: int = 3):
    """A key pair, the rotation keys in Montgomery form and one encryption
    of linspace(−1, 1), made on the scheme's device."""
    gen = torch.Generator(device=sch.device).manual_seed(seed)
    sk, pk = sch.keygen(gen)
    keys = {r: ev.ksk_to_mont(sch.ctx, k) for r, k in sch.rotation_key_gen(sk, rots, gen).items()}
    v = np.linspace(-1, 1, sch.encoder.slots)
    return types.SimpleNamespace(sk=sk, keys=keys, v=v, ct=sch.encrypt_values(pk, v, gen))


def units(sch: CkksScheme, ct: Ciphertext, keys: dict, rots=ROTS) -> dict:
    """The three ways, each a callable giving its output ciphertexts."""
    return {"plain": lambda: [sch.rotate(ct, r, keys) for r in rots],
            "hoisted": lambda: sch.rotate_hoisted(ct, rots, keys),
            "rot_sum": lambda: [sch.rotate_sum_hoisted(ct, rots, keys)]}


def check(sch: CkksScheme, w, outs: dict, rots=ROTS) -> dict:
    """The gates' numbers: the hoisted error, plain = hoisted, the sum's
    error (first 64 slots)."""
    k = min(CHECK_SLOTS, sch.encoder.slots)
    err = max(float(np.abs(sch.decrypt(w.sk, o, num=k) - np.roll(w.v, -r)[:k]).max())
              for r, o in zip(rots, outs["hoisted"]))
    want = sum(np.roll(w.v, -r) for r in rots)[:k]
    err_s = float(np.abs(sch.decrypt(w.sk, outs["rot_sum"][0], num=k) - want).max())
    same = all(torch.equal(p.data, h.data) for p, h in zip(outs["plain"], outs["hoisted"]))
    return {"err": err, "plain_matches": same, "err_sum": err_s,
            "correct": bool(np.isfinite(err) and err < ERR_GATE and same and np.isfinite(err_s)
                            and err_s < SUM_GATE)}


def bench(device="cuda", n: int = N, impl: str | None = None, rots=ROTS, reps: int = 3,
          out=print) -> dict:
    """Set up, run the three ways once against the gates, time each (on the
    card), print the JSON line with ``out`` and return it; raises after
    printing when a gate fails. On the CPU nothing is timed."""
    device = torch.device(device)
    card = card_line() if device.type == "cuda" else None
    t0 = time.perf_counter()
    sch = CkksScheme(params(n, impl), device=device)
    w = world(sch, rots)
    fns = units(sch, w.ct, w.keys, rots)
    outs = {name: fn() for name, fn in fns.items()}
    c = check(sch, w, outs, rots)
    t_setup = time.perf_counter() - t0
    us, parts = {}, {}
    if device.type == "cuda":
        work = w.ct.data.clone()
        for name in fns:
            unit = units(sch, Ciphertext(work, w.ct.scale), w.keys, rots)[name]
            m = timing.marginal_carried_ms(lambda: [o.data for o in unit()], work, R_LO, R_HI,
                                           reps)
            m.update(timing.unit_report(f"rotations {name}", unit, m["ms"], card))
            us[name] = m["ms"] * 1e3 / len(rots)
            parts[name] = m
    else:
        us = dict.fromkeys(fns)
    speed = lambda a, b: None if us[a] is None else us[a] / us[b]
    result = {"metric": f"hoisted_rotation_us_per_rotation_n{n}", "value": us["hoisted"],
              "unit": "us", "plain_us": us["plain"], "hoisting_speedup": speed("plain", "hoisted"),
              "rot_sum_us": us["rot_sum"], "rot_sum_speedup": speed("plain", "rot_sum"),
              "correct": c["correct"], "err": c["err"], "err_sum": c["err_sum"],
              "plain_matches": c["plain_matches"], "rotations": len(rots),
              "setup_seconds": t_setup, "timing": parts, "card": card}
    out(json.dumps(result))
    if not c["correct"]:
        raise AssertionError(f"rotations: a gate failed: {c}")
    return result


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rotations bench: needs a CUDA GPU")
    bench("cuda")


if __name__ == "__main__":
    main()
