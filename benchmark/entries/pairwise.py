"""The pairwise server round (the reference pipeline's server): client 0's
batch re-keyed into client 1's domain (PRE), FedAvg ÷2, the average
re-keyed back to client 0, as ``fl.api.server_round`` composes it; timed
through ``fl.compiled.CompiledRound``, the round as one CUDA graph. The
pool holds ``input_sets`` distinct encryptions per client, stacked apart
from the graph's static inputs, so every call copies its inputs in."""

from __future__ import annotations

import torch

from ppqsflhe_tpu_torch.ckks.types import Ciphertext
from ppqsflhe_tpu_torch.fl.api import server_round
from ppqsflhe_tpu_torch.fl.compiled import CompiledRound

CLIENTS = 2


class Entry:
    def __init__(self, sch, keys, payloads, lazy: int, gen: torch.Generator):
        if len(keys) != CLIENTS:
            raise ValueError(f"the pairwise round takes {CLIENTS} clients, not {len(keys)}")
        (sk0, pk0), (sk1, pk1) = keys
        self.sch, self.lazy = sch, lazy
        self.rk01 = sch.rekey_gen(sk0, pk1, gen)
        self.rk10 = sch.rekey_gen(sk1, pk0, gen)
        pools = [[], []]
        for per_client in payloads:
            for c, (pk, vecs) in enumerate(zip((pk0, pk1), per_client)):
                ct = sch.encrypt_values(pk, vecs, gen)     # (B, 2, L, N) at full level
                pools[c].append(ct.data)
        self.scale = ct.scale            # Δ, under FLEXIBLEAUTOEXT Δ·q_ext
        self.pool0, self.pool1 = (torch.stack(p) for p in pools)
        self.sets = self.pool0.shape[0]
        self.round, self.launches = None, None

    def start(self):
        """The timed entry: the round captured as one CUDA graph."""
        self.round = CompiledRound(self.sch, self.rk01, self.rk10, self.lazy,
                                   self.pool0.shape[1:2], self.scale)
        self.launches = self.round.launches

    def eager(self):
        """The same round run eagerly (where no graph can be captured)."""
        return lambda a, b: server_round(self.sch, a, b, self.rk01, self.rk10, self.lazy)

    def __call__(self, k: int):
        """Round ``k`` on input set k mod sets → ((average, scale), (its
        re-encryption to client 0 as a (1, B, 2, l, N) stack, scale))."""
        s = k % self.sets
        avg, back = self.round(Ciphertext(self.pool0[s], self.scale),
                               Ciphertext(self.pool1[s], self.scale))
        return (avg.data, avg.scale), (back.data.unsqueeze(0), back.scale)
