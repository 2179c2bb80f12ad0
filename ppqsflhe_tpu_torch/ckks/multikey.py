"""Multikey encrypted aggregation on one device.

Twin of :mod:`ppqsflhe_tpu.ckks.multikey`'s single-device path: the
reference's 2-client ``aggregateEncryptedWeights`` (EvalAdd + EvalMult 0.5)
generalised to N ciphertexts already in one key domain, the 1/N folded
into one scalar EvalMult + rescale (FLEXIBLEAUTO: the scale is kept, one
limb goes). Each ciphertext may be a batch (..., 2, l, N).

:func:`aggregate_sharded` is the mesh variant (``multikey.py:57-96``) on
``torch.distributed``: each rank folds its own clients' residues mod q, then
one modular psum over the ``client`` axis gives every rank the sum.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.modarith import modadd
from ..parallel.mesh import axis_group, psum_mod
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
    q, _, _ = ctx.limb_consts(ctx.q_idx(l), ct_stack.device)
    agg = psum_mod(fold_local(ct_stack, q), q, axis_group(mesh, axis))
    if not average:
        return Ciphertext(data=agg, scale=scale)
    avg = ev.mult_scalar(ctx, Ciphertext(data=agg, scale=scale), 1.0 / n_clients_total)
    return Ciphertext(data=avg.data, scale=scale)
