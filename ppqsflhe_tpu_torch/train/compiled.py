"""The compiled training step and validation MSE: :func:`.trainer.train_step`
and :func:`.trainer.val_mse` each captured once as a CUDA graph and
replayed.

Counterpart of the JAX trainer's ``jax.jit`` step (value-and-grad, then
optax Adam) and ``eval_mse`` (``ppqsflhe_tpu/train/trainer.py:108-118``).
Eagerly, a full-width GRU step is about 6,900 launches (72 time steps × 2
layers, forward and backward), each enqueued by Python; as a graph the
host enqueues one replay.

:class:`CompiledStep` owns a static ``(batch,)`` index buffer over the
training set on the device; the gather runs inside the graph. A training
step is not pure: it moves the weights, the Adam moments and count, and
the dropout generator. So its warm-up steps are real steps: the first
:data:`WARMUP` calls run the eager step (the same function) on a side
stream, the next call captures it and replays, and every later call
replays. The trajectory is the eager one by construction, and a replay
draws each step's dropout mask from the generator's state at that step:
the generator is registered with the graph
(``CUDAGraph.register_generator_state``), which advances its offset by the
captured draws at every replay. :class:`CompiledEval` is the no-grad
forward on a static validation set, captured once after a throw-away
eager call (it changes no state).

There is no eager fallback: on a CPU model, or when a capture fails, the
constructor or call raises. Outputs are the graphs' static buffers, copied
out. The capture and the side-stream warm-up are :mod:`..utils.graphs`'s;
a replay adds the launches its graph holds of the port's hand-written
kernels (none on this path) to :data:`..utils.graphs.replayed`, and one to
:data:`replays`.
"""

from __future__ import annotations

import time

import torch

from ..utils import graphs
from ..utils.graphs import WARMUP
from .trainer import train_step, val_mse

replays = {"step": 0, "eval": 0}          # graph replays since the last reset


def reset_replays() -> None:
    for k in replays:
        replays[k] = 0


def step_body(model, opt, X, y, idx, generator) -> torch.Tensor:
    """The captured step: :func:`.trainer.train_step` on the rows ``idx``
    of the static (X, y)."""
    return train_step(model, opt, X.index_select(0, idx), y.index_select(0, idx), generator)


def _family(model) -> str:
    return type(model).__module__.rsplit(".", 1)[-1]


def _on_card(what: str, model, *tensors) -> torch.device:
    devices = {t.device for t in tensors} | {p.device for p in model.parameters()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise RuntimeError(f"{what} captures a CUDA graph; the model and data are on "
                           f"{sorted(map(str, devices))} (run the eager trainer there)")
    return next(iter(devices))


class CompiledStep:
    """``train_step(model, opt, X[sel], y[sel], generator)`` as one CUDA
    graph over the static ``X``, ``y`` (on the card) and ``idx``. Call it
    with each batch's ``(batch,)`` indices; it returns the batch MSE."""

    def __init__(self, model, opt, X: torch.Tensor, y: torch.Tensor, batch: int,
                 generator: torch.Generator):
        self.device = _on_card("CompiledStep", model, X, y)
        self.model, self.opt, self.X, self.y, self.generator = model, opt, X, y, generator
        self.idx = torch.zeros(batch, dtype=torch.int64, device=self.device)
        self.what = (f"the {_family(model)} training step (batch {batch} of X "
                     f"{tuple(X.shape)}, y {tuple(y.shape)})")
        self.warm = 0               # eager steps run so far
        self.graph: graphs.Graph | None = None
        self.capture_s: float | None = None

    def _step(self) -> torch.Tensor:
        return step_body(self.model, self.opt, self.X, self.y, self.idx, self.generator)

    def __call__(self, sel: torch.Tensor) -> torch.Tensor:
        self.idx.copy_(sel)
        if self.graph is None and self.warm < WARMUP:
            self.warm += 1
            return graphs.warm_up(self._step, self.device).clone()
        if self.graph is None:
            t0 = time.perf_counter()
            # backward allocates the gradients from the graph's pool
            self.opt.zero_grad(set_to_none=True)
            self.graph = graphs.Graph(self._step, self.what, self.generator)
            self.capture_s = time.perf_counter() - t0
        replays["step"] += 1
        return self.graph.replay().clone()


class CompiledEval:
    """:func:`.trainer.val_mse` of ``model`` on the static ``(X, y)`` as one
    CUDA graph; a call replays it and reads the MSE back as a float."""

    def __init__(self, model, X: torch.Tensor, y: torch.Tensor):
        device = _on_card("CompiledEval", model, X, y)
        graphs.warm_up(lambda: val_mse(model, X, y), device)
        self.graph = graphs.Graph(lambda: val_mse(model, X, y),
                                  f"the {_family(model)} validation MSE (X {tuple(X.shape)})")

    def __call__(self) -> float:
        replays["eval"] += 1
        return float(self.graph.replay())
