"""server.host_ms: what the device waits on the host inside one call of the
compiled round, with no profiler running: the ``round.call`` span's device
ms (eager CUDA events around the whole call) less ``round.load`` (the
copies into the static inputs) and ``round`` (the graph's first to its last
node), a mean over the instrumented rounds (``benchmark/spans.py``)."""

from benchmark import spans


def read(rec):
    return spans.host_ms(rec)
