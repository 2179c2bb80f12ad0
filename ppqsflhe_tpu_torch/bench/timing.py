"""How the bench twins time a unit of work on the card.

The JAX benches chain R units inside one jitted ``lax.scan``, each unit made
data-dependent on the one before by a carry, and report the marginal cost
between two chain lengths (``bench.py:241-271``). Here a chain is R eager
calls between two CUDA events: :func:`marginal_carried_ms` makes each call
rewrite one residue of its input from the previous call's checksum (on the device, so
no call can start before the one before it has finished), and
:func:`marginal_ms` reports (t_hi − t_lo)/(R_hi − R_lo), the best of a few
repetitions of each chain. Eager calls are enqueued by the host, so where
the host's enqueue takes longer than the device's work the marginal reads
the host: :func:`unit_report` puts one unit's device time (torch.profiler),
the host's enqueue time and the device's idle share beside it.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time

import torch


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def chain_ms(step, x0, rounds: int) -> float:
    """CUDA-event ms of ``rounds`` chained calls: x = step(x) from ``x0``."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    x = x0
    torch.cuda.synchronize()
    a.record()
    for _ in range(rounds):
        x = step(x)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def marginal_ms(step, x0, r_lo: int, r_hi: int, reps: int = 3) -> dict:
    """The marginal ms of one chained call between chains of ``r_lo`` and
    ``r_hi`` calls, each chain's time the best of ``reps`` after a warm-up."""
    t = {}
    for r in (r_lo, r_hi):
        chain_ms(step, x0, r)
        t[r] = min(chain_ms(step, x0, r) for _ in range(reps))
    return {"ms": (t[r_hi] - t[r_lo]) / (r_hi - r_lo), "t_lo_ms": t[r_lo], "t_hi_ms": t[r_hi],
            "r_lo": r_lo, "r_hi": r_hi}


def marginal_carried_ms(unit, work: torch.Tensor, r_lo: int, r_hi: int, reps: int = 3) -> dict:
    """:func:`marginal_ms` of ``unit()``, which reads ``work`` and returns a
    list of tensors: each call first rewrites the first residue of ``work``
    from the previous call's checksum (``(base >> 1) + (carry & 1)``, still
    below its modulus); ``work`` is left as it was. A bare tensor from
    ``unit()`` is refused: iterating it would sum each of its slices apart."""
    if isinstance(unit(), torch.Tensor):
        raise TypeError("unit() must return a list of tensors, not a tensor")
    flat = work.view(-1)
    base = flat[0].clone()

    def step(carry):
        flat[0] = (base >> 1) + (carry & 1)
        return sum(t.sum() for t in unit())

    try:
        return marginal_ms(step, torch.zeros((), dtype=torch.int64, device=work.device), r_lo,
                           r_hi, reps)
    finally:
        flat[0] = base


def device_ms(fn, profiles: int = 3) -> float | None:
    """Device ms of one call of ``fn``: the sum of its CUDA activities under
    torch.profiler, after a warm-up call. On the H100 a profile now and then
    lacks some of the activities that ran, or all of them, so this is the
    fullest of ``profiles`` profiles; None when none holds any."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = 0.0
    for _ in range(profiles):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        best = max(best, sum(e.duration_ns() / 1e3 for e in prof.profiler.kineto_results.events()
                             if e.device_type() == torch.autograd.DeviceType.CUDA))
    return best / 1e3 if best else None


def enqueue_ms(fn, calls: int = 5) -> float:
    """Median host ms to enqueue one call of ``fn``, the device drained
    before each."""
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def unit_report(tag: str, fn, marginal: float, card: str) -> dict:
    """One unit's device ms, host enqueue ms and the device's idle share
    against the ``marginal`` ms of a chained unit; printed on stderr."""
    dev, enq = device_ms(fn), enqueue_ms(fn)
    idle = None if dev is None else max(0.0, 1 - dev / marginal)
    bound = ("not measured" if dev is None else "the host (its enqueue is longer than the "
             "device's work, so the marginal measures the host)" if enq > dev else "the device")
    dev_s = "not measured" if dev is None else f"{dev:.3f} ms"
    idle_s = "not measured" if idle is None else f"{idle:.1%}"
    print(f"[{tag}] one unit: device {dev_s}, host enqueue {enq:.3f} ms, marginal "
          f"{marginal:.3f} ms, idle {idle_s}; bound by {bound} ({card})", file=sys.stderr)
    return {"device_ms": dev, "enqueue_ms": enq, "idle_share": idle}
