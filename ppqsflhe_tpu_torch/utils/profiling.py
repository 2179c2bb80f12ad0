"""Tracing: the twin of :mod:`ppqsflhe_tpu.utils.profiling`.

``profile_trace`` wraps ``torch.profiler`` (CPU and CUDA activities) in
place of ``jax.profiler`` and writes a Chrome trace, viewable in Perfetto
or ``chrome://tracing``, under ``log_dir``; ``timed`` is the JAX module's
wall-clock context, copied as it is.
"""

from __future__ import annotations

import contextlib
import os
import time
from datetime import datetime


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block into
    ``log_dir/trace_<pid>_<ns>.json``; the CUDA activities are traced when
    the card is there."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def timed(step: str, role: str = "perf", sink=print):
    t0 = time.time()
    try:
        yield
    finally:
        dt = (time.time() - t0) * 1e3
        sink(f"[{datetime.now().isoformat(timespec='seconds')}] [{role}] [{step}] "
             f"{dt:.1f} ms")
