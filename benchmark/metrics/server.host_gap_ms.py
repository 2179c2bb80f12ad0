"""server.host_gap_ms: what the host adds to a round — the traced spans'
wall less the device's busy time in them (the union of device activity),
over their rounds: the copy-in call, the replay launch, the event wait.
Under the profiler each ``cudaGraphLaunch`` holds the device idle longer
than without it, so the reading is above the untraced one."""


def read(rec):
    rounds = sum(s.rounds for s in rec.spans)
    if not rounds:
        return None
    return sum(s.window_ns - s.busy_ns() for s in rec.spans) / rounds / 1e6
