"""The compiled server round: :func:`.api.server_round` captured once as a
CUDA graph and replayed.

Counterpart of the JAX package's ``jax.jit(server_round)`` (``bench.py:224``):
the round is hundreds of launches, and eagerly each one is enqueued by
Python, so at N=2^14 the host's enqueue takes longer than the device's work.
:class:`CompiledRound` owns static input buffers for both clients' stacks,
warms the eager round up on a side stream (which builds every lazy cache:
the kernel library and its symbols, the context's constant columns, the
NTT tables of :class:`..ops.streamed_ntt.StreamedChain` and
:class:`..ops.cuda_ntt.CudaFourStepNtt`, the limb positions of
``_by_group``, the base extensions' ``ExtParams`` structs), then captures
one call of the unchanged eager :func:`.api.server_round` over those
buffers. A call copies the inputs in, replays the graph and returns the
graph's outputs, bit-equal to the eager round on the same inputs.

There is no eager fallback: on a CPU scheme, or when the capture fails,
the constructor raises. The outputs are the graph's static buffers, so the
next call overwrites them; clone what must outlive it.

Launch counts: the kernel wrappers count the launches they enqueue, so the
warm-up adds to their counters and the capture (which launches nothing) and
a replay do not. Each replay adds the captured launches to :data:`replayed`
instead. The capture helper, the counters and the side-stream warm-up are
:mod:`..utils.graphs`'s, shared with the compiled training step and the
scheme's per-op graphs; the warm-up runs the scheme's operations eagerly,
so the round's warm-up captures no per-op graph.
"""

from __future__ import annotations

import torch

from ..ckks import eval as ev
from ..ckks.scheme import CkksScheme
from ..ckks.types import Ciphertext, KeySwitchKey
from ..utils import graphs, profiling
from ..utils.graphs import (COUNTERS, WARMUP, replayed, reset_replayed,  # noqa: F401
                             wrapper_counts)
from .api import LAZY_MODES, server_round


class CompiledRound:
    """``server_round(sch, ·, ·, rk12, rk21, lazy)`` over two stacks of
    ``batch_shape`` ciphertexts at full level and ``scale``, as one CUDA
    graph. ``stack1``/``stack2`` are the static inputs, ``local_n`` wide
    (``N``, or ``N/D`` on :func:`..parallel.sharded_scheme.scheme_view`,
    whose round captures its collectives too); ``launches`` holds the
    kernel launches of one replay by :data:`COUNTERS` name."""

    def __init__(self, sch: CkksScheme, rk12: KeySwitchKey, rk21: KeySwitchKey, lazy: int,
                 batch_shape, scale: float | None = None):
        device = torch.device(sch.device)
        if device.type != "cuda":
            raise RuntimeError(f"CompiledRound captures a CUDA graph; the scheme is on {device} "
                               "(run fl.api.server_round there)")
        if lazy not in LAZY_MODES:
            raise ValueError(f"lazy={lazy}: one of {LAZY_MODES}")
        self.sch, self.lazy = sch, lazy
        self.scale = sch.params.scale if scale is None else float(scale)
        # the graph reads the keys by address: keep them (converted once, as
        # keyswitch_ip would convert them on every call)
        self.rk12, self.rk21 = (ev.ksk_to_mont(sch.ctx, k) for k in (rk12, rk21))
        shape = tuple(batch_shape) + (2, sch.params.num_q, sch.ctx.local_n)
        self.stack1 = torch.zeros(shape, dtype=torch.int64, device=device)
        self.stack2 = torch.zeros_like(self.stack1)

        graphs.warm_up(self._round, device, WARMUP)
        torch.cuda.synchronize(device)
        self.graph = graphs.Graph(self._round, f"the server round (lazy={lazy})")
        self.avg, self.back = self.graph.output
        self.launches = self.graph.launches

    def _round(self):
        return server_round(self.sch, Ciphertext(self.stack1, self.scale),
                            Ciphertext(self.stack2, self.scale), self.rk12, self.rk21, self.lazy)

    def _load(self, dst: torch.Tensor, ct: Ciphertext, name: str) -> None:
        if ct.scale != self.scale or tuple(ct.data.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: {tuple(ct.data.shape)} at scale {ct.scale}; the graph "
                             f"was captured for {tuple(dst.shape)} at scale {self.scale}")
        if ct.data is not dst:
            dst.copy_(ct.data)

    def replay(self):
        """Run the graph on the static inputs as they stand → (average in
        client 2's domain, average re-encrypted to client 1)."""
        return self.graph.replay()

    def __call__(self, stack1: Ciphertext, stack2: Ciphertext):
        """Copy the stacks into the static inputs (skipped for a stack that
        is the static input) and :meth:`replay`; traced as the spans
        ``round.call``, ``round.load`` and ``round.replay``."""
        with profiling.span("round.call"):
            with profiling.span("round.load"):
                self._load(self.stack1, stack1, "stack1")
                self._load(self.stack2, stack2, "stack2")
            with profiling.span("round.replay", device=False):
                return self.replay()
