"""device.idle_share: 1 − the device's busy time (the union of device
activity) ÷ the wall of the traced spans, over the same spans, in %: the
share that the result line's ``device.busy_s`` and ``device.window_s``
give. Under the profiler each ``cudaGraphLaunch`` holds the device idle
longer than without it, so the reading is above the untraced one."""


def read(rec):
    window = sum(s.window_ns for s in rec.spans)
    if not window:
        return None
    return 100.0 * (1 - sum(s.busy_ns() for s in rec.spans) / window)
