"""The 16-client multikey round: clients 0 … C−2 re-keyed into the hub's
(client C−1) domain, summed, ÷C, and the average re-keyed back to each of
them; timed through ``bench.multikey.CompiledMultikeyRound``, the round as
one CUDA graph (program code; it lives in the port's ``bench/`` module).
The pool holds each client's encryption at the round's inbound level,
stacked apart from the graph's static stacks, so every call copies it in."""

from __future__ import annotations

import torch

from ppqsflhe_tpu_torch.bench import multikey
from ppqsflhe_tpu_torch.ckks.types import Ciphertext


class Entry:
    def __init__(self, sch, keys, payloads, lazy: int, gen: torch.Generator):
        self.sch, self.lazy = sch, lazy
        sk_hub, pk_hub = keys[-1]
        self.rk_to = [sch.rekey_gen(sk, pk_hub, gen) for sk, _ in keys[:-1]]
        self.rk_from = [sch.rekey_gen(sk_hub, pk, gen) for _, pk in keys[:-1]]
        l_in = multikey.inbound_level(sch, lazy)
        pool = []
        for per_client in payloads:
            cts = [sch.encrypt_values(pk, vecs, gen) for (_, pk), vecs in zip(keys, per_client)]
            self.scale = cts[0].scale    # Δ, under FLEXIBLEAUTOEXT Δ·q_ext
            pool.append(torch.stack([ct.data[..., :l_in, :] for ct in cts]))
            del cts
        self.pool = torch.stack(pool)
        self.sets = self.pool.shape[0]
        self.round, self.launches = None, None

    def start(self):
        """The timed entry: the round captured as one CUDA graph."""
        self.round = multikey.CompiledMultikeyRound(self.sch, self.rk_to, self.rk_from,
                                                    self.lazy, self.pool.shape[1:], self.scale)
        self.launches = self.round.launches

    def eager(self):
        """The same round run eagerly (where no graph can be captured)."""
        return lambda st: multikey.server_round(self.sch, st, self.rk_to, self.rk_from, self.lazy)

    def __call__(self, k: int):
        """Round ``k`` on input set k mod sets → ((average, scale),
        (re-encryptions (C−1, B, 2, l, N), scale))."""
        avg, outs = self.round(Ciphertext(self.pool[k % self.sets], self.scale))
        return (avg.data, avg.scale), (outs.data, outs.scale)
