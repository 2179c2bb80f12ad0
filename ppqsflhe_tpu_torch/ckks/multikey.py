"""Multikey encrypted aggregation on one device.

Twin of :mod:`ppqsflhe_tpu.ckks.multikey`'s single-device path: the
reference's 2-client ``aggregateEncryptedWeights`` (EvalAdd + EvalMult 0.5)
generalised to N ciphertexts already in one key domain, the 1/N folded
into one scalar EvalMult + rescale (FLEXIBLEAUTO: the scale is kept, one
limb goes). Each ciphertext may be a batch (..., 2, l, N). The mesh variant
(``aggregate_sharded``) belongs with ``torch.distributed`` and is not here.
"""

from __future__ import annotations

from typing import Sequence

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
