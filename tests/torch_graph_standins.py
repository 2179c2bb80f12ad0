"""Stand-ins for the card in the CPU tests of the port's graph caches, and
the host-sync patch; torch and the port only, so that the multi-rank
worker (``tests/torch_dist_worker.py``) uses them as the tests do.

:func:`install` makes every tensor look as if it were on the card and
replaces the CUDA capture by one that records nothing: ``torch.cuda.graph``
runs the function once eagerly, and :class:`ReplayingGraph` (the real
``utils.graphs.Graph`` around that capture, its launch and collective
bookkeeping untouched) runs it again eagerly into the static outputs at
each replay, as a CUDA graph writes its static buffers; the collectives
and launches of those eager re-runs are not counted (a replay's are
tallied from the capture), nor are their spans (a replay queues the
captured ones). The warm-up runs on the current thread, inside
``graphs.eager()``.
"""

import contextlib

import torch

from ppqsflhe_tpu_torch.ckks import scheme as scheme_mod
from ppqsflhe_tpu_torch.parallel import mesh as pm
from ppqsflhe_tpu_torch.utils import graphs, profiling

# what a capture cannot contain: a copy to the host, a host value read from
# a tensor, or an upload from the host (tests/test_torch_compiled.py's list)
HOST_SYNCS = ((torch.Tensor, "item"), (torch.Tensor, "tolist"), (torch.Tensor, "cpu"),
              (torch.Tensor, "numpy"), (torch.Tensor, "__bool__"), (torch.Tensor, "__int__"),
              (torch.Tensor, "__float__"), (torch, "tensor"), (torch, "as_tensor"),
              (torch, "from_numpy"))

_RealGraph = graphs.Graph


class FakeCUDAGraph:
    def register_generator_state(self, generator):
        pass

    def replay(self):
        pass

    def reset(self):
        pass


@contextlib.contextmanager
def fake_capture(graph, capture_error_mode="global"):
    yield


class ReplayingGraph(_RealGraph):
    """``utils.graphs.Graph`` over :func:`fake_capture`; each replay also
    re-runs the function eagerly into the static outputs, uncounted."""

    captures = []

    def __init__(self, fn, what, generator=None):
        self.fn = fn
        with graphs.eager():
            super().__init__(fn, what, generator)
        ReplayingGraph.captures.append(what)

    def replay(self):
        out = super().replay()
        colls, launches = pm.read_collectives(), graphs.wrapper_counts()
        with graphs.eager(), profiling.capturing():     # its spans were queued by the replay
            fresh = self.fn()
        pm.restore_collectives(colls)
        graphs._set_wrapper_counts(launches)
        for dst, src in zip(graphs._tensors(out), graphs._tensors(fresh)):
            dst.copy_(src)
        return out


warmed = []     # the devices of the warm-ups, in call order


def eager_warm_up(fn, device, n=1):
    with graphs.eager():
        for _ in range(n):
            out = fn()
    warmed.append(str(device))
    return out


def install(setattr_):
    """Install the stand-ins with ``setattr_(owner, name, value)`` (a
    monkeypatch's, or ``setattr`` in a worker process)."""
    ReplayingGraph.captures = []
    warmed.clear()
    setattr_(torch.cuda, "CUDAGraph", FakeCUDAGraph)
    setattr_(torch.cuda, "graph", fake_capture)
    setattr_(graphs, "Graph", ReplayingGraph)
    setattr_(graphs, "warm_up", eager_warm_up)
    setattr_(graphs, "on_card", lambda x: True)
    setattr_(scheme_mod, "_on_card", lambda t: True)


def refuse(name):
    def fail(*args, **kwargs):
        raise AssertionError(f"host sync {name} in a body that is captured")
    return fail


def refuse_host_syncs(setattr_):
    for owner, name in HOST_SYNCS:
        setattr_(owner, name, refuse(name))
