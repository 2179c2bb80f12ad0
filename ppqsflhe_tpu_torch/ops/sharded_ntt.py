"""Coefficient-sharded negacyclic NTT over the ranks of a mesh axis.

Twin of :mod:`ppqsflhe_tpu.ops.sharded_ntt`. A length-N transform with the
polynomial's coefficients sharded across D ranks needs one exchange: the
four-step factorization cuts it at its transpose, which becomes one tiled
all-to-all between two local column stages::

    local:  stage A: twist, m1-point column NTT, twiddle   (no comms)
    comm:   all-to-all, the distributed transpose          (1 collective)
    local:  stage B along the exchanged rows               (no comms)

The local stages are those of the streamed pair (:mod:`.streamed_ntt`):
on the card kernel 4 (``stage_a`` on the rank's column block at
``col0 = rank·c``, its twiddle table m2 columns wide) and kernel 5
(``stage_b`` over the m1/D exchanged rows); on the CPU their plain
versions. The JAX class runs the same two phases as XLA Shoup column
stages (``_col_gs64`` / ``_col_ct64``); the functions and the order of the
output are the same.

Layouts, as in the JAX package: a coefficient-domain limb viewed as an
(n1, n2) matrix is sharded on n2, so rank r holds columns [r·n2/D,
(r+1)·n2/D); the transform leaves it in the four-step kernel order viewed
as (n2, n1), sharded on n1. The inverse runs the mirror image. The coef
axis takes every D that the JAX classes take, any D dividing n1 and n2 (up
to 64 ranks at N=2^12, 256 at N=2^16): the kernels take m ∈ {8, …, 256}
and blocks of whole 16-wide tiles or of a power of two below 16 columns
(stage A) or rows (stage B), and since n1 and n2 are powers of two, so are
a shard's n2/D columns and m1/D rows. :func:`check_shards` raises on any
device where the JAX classes raise, so a CPU run accepts exactly the meshes
the card accepts.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..parallel.mesh import all_to_all_tiled, axis_group, axis_index, axis_size
from .cuda_mxu_ntt import MxuChainTables
from .streamed_ntt import SIZES, stage_a, stage_a_plain, stage_b, stage_b_plain


def check_shards(n1: int, n2: int, D: int) -> None:
    """Raise ValueError unless D ranks can each run kernels 4 and 5 on their
    shard of an (n1, n2) four-step transform: n1 and n2 in the kernels'
    :data:`.streamed_ntt.SIZES` (N = 2^6 … 2^16), and D dividing both, the
    JAX classes' condition."""
    if n1 not in SIZES or n2 not in SIZES:
        raise ValueError(f"the sharded transform takes n1, n2 in {SIZES}, got {n1}, {n2}")
    if D < 1 or n1 % D or n2 % D:
        raise ValueError(f"coef axis size {D} must divide n1={n1}, n2={n2}")


def halves(x: torch.Tensor, chain, sel: Sequence[int], forward: bool, rank: int, D: int,
           group) -> torch.Tensor:
    """One sharded transform of x (B, L, m1, m2/D), rank ``rank``'s column
    block of L limbs (``sel`` of ``chain``, a :class:`.streamed_ntt.StreamedChain`)
    → (B, L, m2, m1/D), its block of the transposed output: stage A, the
    all-to-all over ``group``, stage B."""
    B, L, m1, c = x.shape
    m2 = c * D
    if x.is_cuda:
        x = x.contiguous()
        tabs, info_a, info_b = chain.device(x.device, sel, forward)
        y = stage_a(x, torch.empty_like(x), tabs, info_a, forward, m2, rank * c)
    else:
        limbs = [chain.limb(i) for i in sel]
        y = stage_a_plain(x, limbs, forward, rank * c)
    t = all_to_all_tiled(y, group, split_axis=2, concat_axis=3)      # (B, L, m1/D, m2)
    if x.is_cuda:
        z = torch.empty((B, L, m2, m1 // D), dtype=torch.int64, device=x.device)
        return stage_b(t, z, tabs, info_b, forward)
    return stage_b_plain(t, limbs, forward)


class ShardedNtt:
    """Mesh-sharded four-step NTT for one RNS limb stack. ``ntt`` takes this
    rank's shard (..., L, n1, n2/D) of the coefficient matrices and returns
    its shard (..., L, n2, n1/D) of the kernel-order evaluations; ``intt``
    the reverse. D is the size of the mesh axis ``axis``."""

    def __init__(self, n: int, moduli: Sequence[int], psis: Sequence[int], mesh,
                 axis: str = "coef"):
        self.n = n
        self.mesh, self.axis = mesh, axis
        self.tables = MxuChainTables(n, moduli, psis)
        self.n1, self.n2 = self.tables.n1, self.tables.n2
        self.D, self.rank = axis_size(mesh, axis), axis_index(mesh, axis)
        self.group = axis_group(mesh, axis)
        check_shards(self.n1, self.n2, self.D)
        self.moduli = tuple(int(q) for q in moduli)

    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, True)

    def intt(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, False)

    def _run(self, x, forward):
        L = len(self.moduli)
        m1, m2 = (self.n1, self.n2) if forward else (self.n2, self.n1)
        lead = x.shape[:-3]
        if tuple(x.shape[-3:]) != (L, m1, m2 // self.D):
            raise ValueError(f"expected a shard (..., {L}, {m1}, {m2 // self.D}), got "
                             f"{tuple(x.shape)}")
        y = halves(x.reshape(-1, L, m1, m2 // self.D), self.tables.streamed, list(range(L)),
                   forward, self.rank, self.D, self.group)
        return y.reshape(lead + (L, m2, m1 // self.D))
