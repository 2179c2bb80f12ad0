"""CUDA-graph capture, shared by every compiled path of the port.

The JAX package compiles with ``jax.jit``; the port captures the same
functions as ``torch.cuda.CUDAGraph``s. These pieces serve every capture:

- :func:`warm_up` runs a function on a side stream (``n`` calls, the
  current stream waiting for them) so that every lazy cache it builds (the
  kernel library, constant columns, NTT tables) exists before a capture;
- :class:`Graph` captures one call, optionally with a generator registered,
  raises ``RuntimeError`` naming what failed, and counts the kernels and the
  collectives it holds: the wrappers' launch counters and the mesh's
  collective counter (:data:`..parallel.mesh.collectives`) are read around
  the capture and restored, since a capture launches and issues nothing,
  and each :meth:`Graph.replay` adds the captured launches to
  :data:`replayed` and the captured collectives to
  :data:`replayed_collectives`. A graph that holds collectives is tied to
  the process groups (:func:`..parallel.mesh.tie`): released before they
  are destroyed, after which a replay raises;
- :class:`OpGraph` is one cached call at one key (:data:`WARMUP` eager
  calls, one capture over static copies of the inputs, then replays, each
  result cloned) and :class:`GraphCache` holds them by key (the JAX key
  plus the inputs' :func:`signature`): the scheme's per-op cache, the
  sharded context's cache of ``cached_jit`` compositions and
  :func:`group_cache`, that of the mesh functions on a plain context;
- :func:`eager` scopes calls whose scheme operations must run their eager
  bodies: :class:`..ckks.scheme.CkksScheme` caches a graph per operation,
  and :func:`bypass` tells it where not to (inside :func:`eager`, which
  every :func:`warm_up` enters, and while the current stream captures, so
  that a whole-program graph holds the operations' kernels itself).

The scope is process-wide state, not per thread.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch
import torch.distributed as dist

from ..ckks.types import Ciphertext, KeySwitchKey, Plaintext
from ..ops import cuda_ext, cuda_ks, cuda_mxu_ntt, cuda_ntt, streamed_ntt
from ..parallel import mesh
from . import profiling

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
# collectives run by replays since the last reset, as mesh.collectives counts them
replayed_collectives = {k: {"ops": 0, "bytes": 0} for k in mesh.collectives}
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
    for c in replayed_collectives.values():
        c["ops"] = c["bytes"] = 0


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


def _capture_mode() -> str:
    """``"thread_local"`` where an NCCL group exists (its watchdog thread
    queries the events of earlier collectives while a capture runs, which a
    process-wide capture refuses), else ``"global"``."""
    nccl = dist.is_available() and dist.is_initialized() and dist.get_backend() == "nccl"
    return "thread_local" if nccl else "global"


class Graph:
    """One captured call of ``fn``: ``output`` is its static result,
    ``launches`` the kernel launches it holds, by :data:`COUNTERS` name,
    ``collectives`` the collectives, as :data:`..parallel.mesh.collectives`
    counts them, and ``spans`` the device spans captured into it (empty
    unless :func:`.profiling.tracing` was on), which each replay queues."""

    def __init__(self, fn, what: str, generator: torch.Generator | None = None):
        self.what = what
        before, colls = wrapper_counts(), mesh.read_collectives()
        try:
            self.graph = torch.cuda.CUDAGraph()
            if generator is not None:
                self.graph.register_generator_state(generator)
            with profiling.capturing() as self.spans, \
                    torch.cuda.graph(self.graph, capture_error_mode=_capture_mode()):
                self.output = fn()
        except Exception as e:
            raise RuntimeError(f"capture of {what} failed: {e}") from e
        finally:
            after, colls_after = wrapper_counts(), mesh.read_collectives()
            _set_wrapper_counts(before)
            mesh.restore_collectives(colls)
        self.launches = {k: v - before[k] for k, v in after.items()}
        self.collectives = {k: {f: v - colls[k][f] for f, v in c.items()}
                            for k, c in colls_after.items()}
        if any(c["ops"] for c in self.collectives.values()):
            mesh.tie(self)

    def replay(self):
        """Run the graph on its static inputs as they stand → ``output``."""
        if self.graph is None:
            raise RuntimeError(f"{self.what}: its graph was released with the process groups "
                               "whose collectives it held; nothing to replay")
        if self.spans:
            profiling.queue(self.spans)
        self.graph.replay()
        for k, v in self.launches.items():
            replayed[k] += v
        for k, c in self.collectives.items():
            for f, v in c.items():
                replayed_collectives[k][f] += v
        return self.output

    def release(self) -> None:
        """Free the CUDA graph (its kernels, collectives and memory pool)."""
        if self.graph is not None:
            self.graph.reset()
            self.graph = self.output = None


# ---------------------------------------------------------------------------
# Cached calls: the counterpart of a jit cache keyed by static configuration
# ---------------------------------------------------------------------------

def leaf(x) -> torch.Tensor:
    """An input's tensor: itself, or the ``data`` of a ciphertext, plaintext
    or key."""
    return x if isinstance(x, torch.Tensor) else x.data


def _with_leaf(x, t: torch.Tensor):
    """``x`` with its tensor replaced by ``t``."""
    return t if isinstance(x, torch.Tensor) else dataclasses.replace(x, data=t)


def signature(x) -> tuple:
    """An input's part of a cache key: its type, shape, dtype, device and
    the host metadata a body reads (a scale, a key's ``mont`` flag)."""
    t = leaf(x)
    meta = (x.scale if isinstance(x, (Ciphertext, Plaintext))
            else x.mont if isinstance(x, KeySwitchKey) else None)
    return (type(x).__name__, tuple(t.shape), t.dtype, str(t.device), meta)


def _clone(out):
    if isinstance(out, (tuple, list)):
        return type(out)(_clone(o) for o in out)
    return (out.clone() if isinstance(out, torch.Tensor)
            else dataclasses.replace(out, data=out.data.clone()))


def on_card(x) -> bool:
    return leaf(x).is_cuda


class OpGraph:
    """One cached call at one key: :data:`WARMUP` eager calls on a side
    stream, then one capture over static copies of the inputs, then
    replays; every call's result is the caller's own. With ``scrub`` the
    static inputs and outputs are zeroed after each replay's result is
    cloned, so the cache keeps no copy of a secret, a draw or a plaintext
    between calls. Once released (its process groups destroyed) a call
    raises."""

    def __init__(self, what: str, body, scrub: bool = False):
        self.what, self.body, self.scrub = what, body, scrub
        self.calls = 0              # eager warm-up calls so far
        self.replays = 0
        self.static = None          # the inputs' static buffers
        self.graph = None
        self.released = False

    def _load(self, leaves) -> None:
        for dst, t in zip(self.static, leaves):
            if t is not dst:
                dst.copy_(t)

    def __call__(self, inputs):
        if self.released:
            raise RuntimeError(f"{self.what}: released with the process groups its "
                               "collectives ran on; no graph to replay")
        leaves = [leaf(x) for x in inputs]
        if self.graph is None and self.calls < WARMUP:
            self.calls += 1
            return warm_up(lambda: self.body(*inputs), leaves[0].device)
        if self.graph is None:
            self.static = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in leaves]
            args = [_with_leaf(x, t) for x, t in zip(inputs, self.static)]
            self._load(leaves)
            self.graph = Graph(lambda: self.body(*args), self.what)
        else:
            self._load(leaves)
        out = _clone(self.graph.replay())
        self.replays += 1
        if self.scrub:
            for t in [*self.static, *_tensors(self.graph.output)]:
                t.zero_()
        return out

    def release(self) -> None:
        if self.graph is not None:
            self.graph.release()
        self.graph = self.static = None
        self.released = True


class GraphCache(dict):
    """:class:`OpGraph`s by key: the JAX key plus the inputs'
    :func:`signature`s. ``tied``: its graphs hold collectives, so the cache
    is tied to the process groups (:func:`..parallel.mesh.tie`) and
    :meth:`release`d, every entry dropped, before they are destroyed."""

    def __init__(self, tied: bool = False):
        super().__init__()
        if tied:
            mesh.tie(self)

    def run(self, key, what: str, body, inputs, scrub: bool = False):
        """``body(*inputs)`` through the entry of ``key`` and the inputs'
        signatures; ``what`` names it in a failed capture's error."""
        full = (key,) + tuple(signature(x) for x in inputs)
        op = self.get(full)
        if op is None:
            op = self[full] = OpGraph(f"{what} {full}", body, scrub)
        return op(inputs)

    def release(self) -> None:
        for op in self.values():
            op.release()
        self.clear()


def cached(cache: GraphCache, key, what: str, body, *inputs, scrub: bool = False):
    """``body(*inputs)`` through ``cache`` where the first input is on the
    card; eagerly on the CPU, inside :func:`eager` and while the current
    stream captures (an enclosing graph then holds the body's kernels)."""
    if not on_card(inputs[0]) or bypass():
        return body(*inputs)
    return cache.run(key, what, body, inputs, scrub)


_group_caches = weakref.WeakKeyDictionary()     # process group → its GraphCache


def group_cache(group) -> GraphCache:
    """The cache of the mesh functions that take a plain context and a
    mesh (``multikey.aggregate_sharded``, the threshold psums) on
    ``group``, tied to the process groups."""
    cache = _group_caches.get(group)
    if cache is None:
        cache = _group_caches[group] = GraphCache(tied=True)
    return cache
