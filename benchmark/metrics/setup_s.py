"""setup_s: from the process's start to the first timed round — imports,
the kernel library (built on a checkout's first run), keys, encryptions,
the warm-up rounds and the graph capture (host clock)."""


def read(rec):
    return rec.setup_s
