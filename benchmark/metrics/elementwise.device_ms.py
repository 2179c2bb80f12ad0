"""elementwise.device_ms: device ms a round in every kernel that is not
one of the port's hand-written NTT or key-switch kernels (today torch's
elementwise and indexing kernels: the modular arithmetic of ``ckks/eval.py``
and ``core/modarith.py``). Copies and fills are not kernels and are left
out."""

from benchmark.trace import SYMBOLS, is_copy


def read(rec):
    rounds = sum(s.rounds for s in rec.spans)
    if not rounds:
        return None
    ns = sum(e - b for s in rec.spans for name, b, e in s.device
             if not is_copy(name) and not any(sym in name for sym in SYMBOLS.values()))
    return ns / rounds / 1e6
