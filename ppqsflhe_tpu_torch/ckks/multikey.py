"""Multikey encrypted aggregation on one device.

Twin of :mod:`ppqsflhe_tpu.ckks.multikey`'s single-device path: the
reference's 2-client ``aggregateEncryptedWeights`` (EvalAdd + EvalMult 0.5)
generalised to N ciphertexts already in one key domain, the 1/N folded
into one scalar EvalMult + rescale (FLEXIBLEAUTO: the scale is kept, one
limb goes). Each ciphertext may be a batch (..., 2, l, N).

:func:`aggregate_sharded` is the mesh variant (``multikey.py:57-96``) on
``torch.distributed``: each rank folds its own clients' residues mod q, then
one modular psum over the ``client`` axis gives every rank the sum. The JAX
function jits its ``shard_map``; on the card this one runs as a CUDA graph
per (context, group, scale, count, average and the stack's signature),
the psum's all-reduce captured inside (:func:`..utils.graphs.group_cache`).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.modarith import modadd
from ..parallel.mesh import axis_group, psum_mod
from ..utils import graphs
from . import eval as ev
from .params import CkksContext
from .types import Ciphertext


def aggregate_local(ctx: CkksContext, cts: Sequence[Ciphertext],
                    scale_by_count: bool = True) -> Ciphertext:
    """Σ cts, then × 1/len(cts) (``scale_by_count``)."""
    out = cts[0]
    for ct in cts[1:]:
        out = ev.add(ctx, out, ct)
    if scale_by_count:
        out = ev.mult_scalar(ctx, out, 1.0 / len(cts))
    return out


def fold_local(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Σ_i x[i] mod q over the leading (local clients or parties) axis."""
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = modadd(acc, x[i], q)
    return acc


def aggregate_sharded(ctx: CkksContext, ct_stack: torch.Tensor, mesh, scale: float,
                      n_clients_total: int, average: bool = True,
                      axis: str = "client") -> Ciphertext:
    """Mesh-parallel encrypted FedAvg. ``ct_stack``: this rank's clients,
    (clients_local, B, k, l, N), all in the common key domain. The local sum
    mod q, one modular psum over ``axis``, then × 1/``n_clients_total`` as a
    scalar EvalMult + rescale (the scale kept, one limb gone) unless
    ``average`` is False. Returns the aggregate batch (B, k, l', N), the
    same on every rank."""
    l = ct_stack.shape[-2]
    group = axis_group(mesh, axis)

    def body(stack):
        q, _, _ = ctx.limb_consts(ctx.q_idx(l), stack.device)
        agg = psum_mod(fold_local(stack, q), q, group)
        if not average:
            return agg
        return ev.mult_scalar(ctx, Ciphertext(data=agg, scale=scale), 1.0 / n_clients_total).data

    key = ("aggregate_sharded", ctx, float(scale), n_clients_total, average)
    data = graphs.cached(graphs.group_cache(group), key, "the mesh function", body, ct_stack)
    return Ciphertext(data=data, scale=scale)
