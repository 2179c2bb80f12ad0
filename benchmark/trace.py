"""Reading the device trace of a traced run: short spans of the window
under ``torch.profiler`` with its CUDA activities only (the device's
operations and the host's CUDA runtime calls, on one clock; CPU operator
events would multiply the cost of reading a profile). A span's window runs
from its first runtime call (the first round's start event) to the end of
its last event (the last round's wait).

The kernel-event reading is copied from ``ppqsflhe_tpu_torch/bench/timing.py``
``device_ms`` and ``bench/multikey.py`` ``device_breakdown`` (kineto events of
``DeviceType.CUDA``, summed by kernel symbol). On the H100 a profile now and
then lacks some of the activities that ran (noted there), so a span is kept
only when it is complete: its launches of each hand-written kernel are the
captured graph's own count (``launches``) times its rounds, and its device
operations per round are as many as the fullest span's."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

# a captured graph's launch counter (ppqsflhe_tpu_torch.utils.graphs.COUNTERS)
# → the kernel symbol it launches
SYMBOLS = {"mxu_ntt": "mxu_ntt_stage_kernel", "mxu_ntt_mont": "mxu_ntt_stage_mont_kernel",
           "streamed_stage_a": "streamed_stage_a_kernel",
           "streamed_stage_b": "streamed_stage_b_kernel", "fourstep_ntt": "fourstep_ntt_kernel",
           "base_extend": "base_extend_kernel", "ks_inner_product": "ks_ip_kernel"}


@dataclass
class Span:
    rounds: int
    start: int                                   # ns, the span's window
    end: int
    device: list = field(default_factory=list)   # (name, start, end) ns
    host: list = field(default_factory=list)     # (name, start, end) ns, innermost first

    @property
    def window_ns(self) -> int:
        return self.end - self.start

    def busy(self) -> list:
        """The union of device activity inside the window, merged
        intervals (start, end)."""
        out = []
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_ns(self) -> int:
        return sum(e - s for s, e in self.busy())

    def count(self, symbol: str) -> int:
        return sum(symbol in name for name, _, _ in self.device)

    def gaps(self) -> list:
        """Idle stretches inside the window, each named by the shortest host
        runtime call running at its middle ("(host: Python)" between calls):
        (name, ns)."""
        edges = [self.start] + [x for iv in self.busy() for x in iv] + [self.end]
        out = []
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid = (s + e) // 2
            name = next((n for n, hs, he in self.host if hs <= mid < he), "(host: Python)")
            out.append((name, e - s))
        return out


def read(prof, rounds: int) -> Span:
    """The span of one profile: its device operations and the host's
    runtime calls."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), e.start_ns(), e.end_ns())
        (device if e.device_type() == torch.autograd.DeviceType.CUDA else host).append(item)
    host.sort(key=lambda h: h[2] - h[1])
    every = device + host
    start = min((h[1] for h in host), default=min((d[1] for d in device), default=0))
    return Span(rounds, start, max((x[2] for x in every), default=start), device, host)


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def complete(spans: list, launches: dict) -> tuple:
    """(kept spans, reasons for each dropped one). Copies are not counted:
    a round whose outputs the check keeps adds one."""
    per_round = [sum(not is_copy(n) for n, _, _ in s.device) / s.rounds for s in spans]
    most = max(per_round, default=0)
    kept, dropped = [], []
    for s, k in zip(spans, per_round):
        off = {sym: (s.count(sym), n * s.rounds) for c, n in launches.items()
               for sym in [SYMBOLS[c]] if s.count(sym) != n * s.rounds}
        if off:
            dropped.append(f"kernel launches (seen, captured × rounds) {off}")
        elif k < most:
            dropped.append(f"{k * s.rounds:.0f} kernels in {s.rounds} rounds, the fullest span "
                           f"{most:.3f} a round")
        else:
            kept.append(s)
    return kept, dropped


def top(items, k: int = 10) -> list:
    """[[name, seconds], …] of the ``k`` largest totals by name."""
    tot = {}
    for name, ns in items:
        tot[name] = tot.get(name, 0) + ns
    return [[n, v / 1e9] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]
