"""round_p95_ms: the 95th percentile of every window round's latency, each
from a CUDA event recorded just before the round's call to one recorded
just after it (the device's own timestamps; the stream is idle when the
first is recorded, so the wait for the host's copy-in and replay counts)."""

import numpy as np


def read(rec):
    return float(np.percentile(rec.latency_ms, 95))
