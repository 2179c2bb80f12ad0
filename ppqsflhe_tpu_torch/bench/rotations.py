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

The units call ``ckks.eval`` directly, so they run eagerly (the scheme's
``rotate`` caches a CUDA graph per rotation). Each is timed as the marginal
cost between 12 and 36 chained passes (:mod:`.timing`), reported in µs per
rotation, beside one pass's device time, the host's enqueue time and the
idle share on stderr. The JAX bench times each unit jitted whole
(``bench_rotations.py:196``), so each is also captured whole as one CUDA
graph over a static ciphertext and the keys (:class:`CompiledUnit`),
held ``torch.equal`` to the eager unit and timed by the same chained
marginal under ``compiled_*`` keys (None on the CPU). Gates
(``bench_rotations.py:227-260``): the hoisted rotations decrypt to the
rolled vector within 1e-3 (first 64 slots), the plain ones are bit-equal to
them, and the sum decrypts within 1e-2. A failed gate raises after the JSON
line is printed. Run on the card::

    python -m ppqsflhe_tpu_torch.bench.rotations

It prints one JSON line with ``bench_rotations.py``'s keys
(``"metric": "hoisted_rotation_us_per_rotation_n32768"``, …; ``value`` is
the eager hoisted unit's) plus the compiled units' keys and ``"card"``. A
compiled unit that differs from the eager one raises after the line, as a
failed gate does.
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
from ..utils import graphs
from . import timing
from .timing import card_line

N = 1 << 15
ROTS = [1, 2, 4, 8, 16, 32, 64, 128]
R_LO, R_HI = 12, 36
ERR_GATE, SUM_GATE = 1e-3, 1e-2
CHECK_SLOTS = 64
COMPILED_KEYS = ("compiled_plain_us", "compiled_us", "compiled_rot_sum_us", "compiled_equal")


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
    """The three ways, each a callable giving its output ciphertexts, run
    eagerly."""
    ctx = sch.ctx
    return {"plain": lambda: [ev.rotate(ctx, ct, r, keys[r]) for r in rots],
            "hoisted": lambda: ev.rotate_hoisted(ctx, ct, rots, keys),
            "rot_sum": lambda: [ev.rotate_sum_hoisted(ctx, ct, rots, keys)]}


class CompiledUnit:
    """One of :func:`units` captured whole as a CUDA graph over the static
    ciphertext ``static`` (a copy of ``ct``) and ``keys`` (read by address:
    keep them), the counterpart of ``jax.jit(fn)`` at
    ``bench_rotations.py:196``; :data:`..utils.graphs.WARMUP` eager passes
    on a side stream first. ``replay()`` runs it on ``static`` as it stands and
    returns the graph's output ciphertexts (overwritten by the next
    replay)."""

    def __init__(self, sch: CkksScheme, name: str, ct: Ciphertext, keys: dict, rots=ROTS):
        if not ct.data.is_cuda:
            raise RuntimeError(f"CompiledUnit captures a CUDA graph; the ciphertext is on "
                               f"{ct.data.device}")
        self.static = ct.data.clone()
        fn = units(sch, Ciphertext(self.static, ct.scale), keys, rots)[name]
        graphs.warm_up(fn, self.static.device, graphs.WARMUP)
        torch.cuda.synchronize(self.static.device)
        t0 = time.perf_counter()
        self.graph = graphs.Graph(fn, f"the {name} rotation unit (R={len(rots)})")
        self.capture_s = time.perf_counter() - t0

    def replay(self) -> list:
        return self.graph.replay()


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
    us, parts, compiled = {}, {}, dict.fromkeys(COMPILED_KEYS)
    if device.type == "cuda":
        work = w.ct.data.clone()
        for name in fns:
            unit = units(sch, Ciphertext(work, w.ct.scale), w.keys, rots)[name]
            m = timing.marginal_carried_ms(lambda: [o.data for o in unit()], work, R_LO, R_HI,
                                           reps)
            m.update(timing.unit_report(f"rotations {name}", unit, m["ms"], card))
            us[name] = m["ms"] * 1e3 / len(rots)
            parts[name] = m
        compiled, parts["compiled"] = measure_compiled(sch, w, fns, rots, card, reps)
    else:
        us = dict.fromkeys(fns)
    speed = lambda a, b: None if us[a] is None else us[a] / us[b]
    result = {"metric": f"hoisted_rotation_us_per_rotation_n{n}", "value": us["hoisted"],
              "unit": "us", "plain_us": us["plain"], "hoisting_speedup": speed("plain", "hoisted"),
              "rot_sum_us": us["rot_sum"], "rot_sum_speedup": speed("plain", "rot_sum"),
              "correct": c["correct"], "err": c["err"], "err_sum": c["err_sum"],
              "plain_matches": c["plain_matches"], "rotations": len(rots),
              "setup_seconds": t_setup, "timing": parts, **compiled, "card": card}
    out(json.dumps(result))
    if not c["correct"]:
        raise AssertionError(f"rotations: a gate failed: {c}")
    if compiled["compiled_equal"] is False:
        raise AssertionError("rotations: a compiled unit differs from the eager unit")
    return result


def measure_compiled(sch: CkksScheme, w, fns: dict, rots, card: str, reps: int = 3):
    """Each unit as a :class:`CompiledUnit`: one replay on the world's
    ciphertext against the eager unit (``compiled_equal``), then the
    chained marginal over replays (each first rewriting one residue of the
    static ciphertext) in µs per rotation, and one replay's device ms,
    enqueue ms and idle share (stderr). Returns (the JSON keys, the timing
    parts by unit)."""
    keys = dict(zip(("plain", "hoisted", "rot_sum"), COMPILED_KEYS))
    out, parts, equal = {}, {}, True
    for name, fn in fns.items():
        cu = CompiledUnit(sch, name, w.ct, w.keys, rots)
        equal &= all(torch.equal(a.data, b.data) and a.scale == b.scale
                     for a, b in zip(cu.replay(), fn()))
        m = timing.marginal_carried_ms(lambda: [o.data for o in cu.replay()], cu.static, R_LO,
                                       R_HI, reps)
        m.update(timing.unit_report(f"compiled rotations {name}", cu.replay, m["ms"], card))
        m["capture_s"] = cu.capture_s
        out[keys[name]] = m["ms"] * 1e3 / len(rots)
        parts[name] = m
    out["compiled_equal"] = equal
    return out, parts


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rotations bench: needs a CUDA GPU")
    bench("cuda")


if __name__ == "__main__":
    main()
