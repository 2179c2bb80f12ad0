"""CUDA-graph capture, shared by every compiled path of the port.

The JAX package compiles with ``jax.jit``; the port captures the same
functions as ``torch.cuda.CUDAGraph``s. Three pieces serve every capture:

- :func:`warm_up` runs a function on a side stream (``n`` calls, the
  current stream waiting for them) so that every lazy cache it builds (the
  kernel library, constant columns, NTT tables) exists before a capture;
- :class:`Graph` captures one call, optionally with a generator registered,
  raises ``RuntimeError`` naming what failed, and counts the kernels it
  holds: the wrappers' counters are read around the capture and restored,
  since a capture launches nothing, and each :meth:`Graph.replay` adds the
  captured launches to :data:`replayed`;
- :func:`eager` scopes calls whose scheme operations must run their eager
  bodies: :class:`..ckks.scheme.CkksScheme` caches a graph per operation,
  and :func:`bypass` tells it where not to (inside :func:`eager`, which
  every :func:`warm_up` enters, and while the current stream captures, so
  that a whole-program graph holds the operations' kernels itself).

The scope is process-wide state, not per thread.
"""

from __future__ import annotations

import contextlib

import torch

from ..ops import cuda_ext, cuda_ks, cuda_mxu_ntt, cuda_ntt, streamed_ntt

# each kernel wrapper's launch counter: (module, attribute)
COUNTERS = {
    "mxu_ntt": (cuda_mxu_ntt, "launches"),
    "mxu_ntt_mont": (cuda_mxu_ntt, "launches_mont"),
    "streamed_stage_a": (streamed_ntt, "launches_stage_a"),
    "streamed_stage_b": (streamed_ntt, "launches_stage_b"),
    "base_extend": (cuda_ext, "launches"),
    "ks_inner_product": (cuda_ks, "launches"),
    "fourstep_ntt": (cuda_ntt, "launches"),
}
replayed = dict.fromkeys(COUNTERS, 0)   # kernel launches run by replays since the last reset
WARMUP = 2      # eager calls on a side stream before a capture (each lazy cache built)

_eager_depth = 0


def wrapper_counts() -> dict:
    """The kernel wrappers' launch counters, by :data:`COUNTERS` name."""
    return {k: getattr(mod, attr) for k, (mod, attr) in COUNTERS.items()}


def _set_wrapper_counts(counts: dict) -> None:
    for k, (mod, attr) in COUNTERS.items():
        setattr(mod, attr, counts[k])


def reset_replayed() -> None:
    for k in replayed:
        replayed[k] = 0


@contextlib.contextmanager
def eager():
    """Scheme operations called inside run their eager bodies: no per-op
    graph is warmed up, captured or replayed."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


def bypass() -> bool:
    """Whether a per-op graph must be skipped here: inside :func:`eager`,
    or while the current stream is capturing (the enclosing graph then
    holds the operation's kernels)."""
    return _eager_depth > 0 or (torch.cuda.is_available()
                                and torch.cuda.is_current_stream_capturing())


def _tensors(obj):
    """The tensors of an output: a tensor, an object with a ``data`` tensor
    (a ciphertext), or a list, tuple or dict of them."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)
    elif isinstance(getattr(obj, "data", None), torch.Tensor):
        yield obj.data


def warm_up(fn, device, n: int = 1):
    """``n`` calls of ``fn`` inside :func:`eager` on a side stream that
    waits for the current one; the current stream then waits for it.
    Returns the last call's result, its tensors marked as used on the
    current stream."""
    device = torch.device(device)
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    out = None
    with eager(), torch.cuda.stream(side):
        for _ in range(n):
            out = fn()
    main.wait_stream(side)
    for t in _tensors(out):
        t.record_stream(main)
    return out


class Graph:
    """One captured call of ``fn``: ``output`` is its static result and
    ``launches`` the kernel launches it holds, by :data:`COUNTERS` name."""

    def __init__(self, fn, what: str, generator: torch.Generator | None = None):
        before = wrapper_counts()
        try:
            self.graph = torch.cuda.CUDAGraph()
            if generator is not None:
                self.graph.register_generator_state(generator)
            with torch.cuda.graph(self.graph):
                self.output = fn()
        except Exception as e:
            raise RuntimeError(f"capture of {what} failed: {e}") from e
        finally:
            after = wrapper_counts()
            _set_wrapper_counts(before)
        self.launches = {k: v - before[k] for k, v in after.items()}

    def replay(self):
        """Run the graph on its static inputs as they stand → ``output``."""
        self.graph.replay()
        for k, v in self.launches.items():
            replayed[k] += v
        return self.output
