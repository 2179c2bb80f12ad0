"""Coefficient-sharded execution of the whole homomorphic server round.

Twin of :mod:`ppqsflhe_tpu.parallel.sharded_scheme`.
:class:`ShardedEvalContext` is a :class:`~..ckks.params.CkksContext` whose
``ntt``/``intt`` run on this rank's shard of the coefficients over the
``coef`` mesh axis: the schedule of the JAX class's ``_halves_pallas``
(``sharded_scheme.py:214-269``) — kernel 4 on the rank's column block,
one tiled all-to-all, kernel 5 on the exchanged rows (:mod:`..ops.sharded_ntt`;
their plain versions on the CPU). Every other CKKS operation (the modular
elementwise ops, the HPS base extension of kernel 2, the key-switch inner
product of kernel 3, the rescale corrections) is coefficient-wise, so the
unchanged :mod:`..ckks.eval` runs on local shards: PRE, FedAvg and rescale
execute sharded, with collectives only where the math needs them —

- ``coef``: one all-to-all inside every NTT and iNTT;
- ``client``: one modular psum for the federated sum.

The JAX functions take global arrays and run a ``shard_map``; the functions
here are its bodies, on this rank's shards, in the JAX layouts:

- a coefficient-domain poly viewed as an (n1, n2) matrix is sharded on n2;
- an evaluation-domain poly (four-step kernel order) viewed as (n2, n1) is
  sharded on n1 (:func:`eval_shard` cuts it, :func:`eval_unshard` stitches
  it); a local poly is flat, (..., l, N/D).

Galois rotations are the one operation that is not coefficient-local:
:func:`rotate_sharded` and :func:`conjugate_sharded` gather each permuted
poly once over ``coef`` and take the rank's slice of the global
permutation, and :func:`rotate_hoisted_sharded` gathers the extended
digits once for a batch of rotations.

The JAX class compiles each of these compositions once per key
(``cached_jit``: ``("reenc", l)``, ``("galois", g, l)``, ``("hoisted", gs,
l)``, ``("fedavg", client_axis, n_clients, B, l, scale)``).
:meth:`ShardedEvalContext.cached_graph` is its counterpart: on the card a
CUDA graph per key and inputs' signatures, captured on each rank with its
NCCL collectives inside (:class:`..utils.graphs.GraphCache`, tied to the
process groups); eagerly on the CPU, where the tests run ``gloo``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Sequence

import torch

from ..ckks import eval as ev
from ..ckks.params import CkksContext, CkksParams
from ..ckks.types import Ciphertext, KeySwitchKey
from ..core.modarith import modadd
from ..ops import cuda_ntt
from ..ops.sharded_ntt import check_shards, halves
from ..utils import graphs
from .mesh import all_gather_stack, axis_group, axis_index, axis_size, psum_mod, shard, unshard


class ShardedEvalContext(CkksContext):
    """A CkksContext whose transforms take and give this rank's shard of
    the coefficients on ``axis``; the local trailing dim is N/D. Both
    four-step implementations (``"pallas_mxu"``, ``"pallas"``) run the same
    per-shard kernels, as the JAX class runs its Pallas stage kernels for
    both names; ``impl`` keeps the name given. The coef axis takes every D
    the JAX class takes, any D dividing n1 and n2
    (:func:`..ops.sharded_ntt.check_shards`)."""

    # its transforms run all-to-alls on the coef axis: the scheme's per-op
    # cache stays off here, as the JAX package has no per-op jit on a
    # sharded context; its compositions are cached by cached_graph, and a
    # whole round on scheme_view by fl.compiled.CompiledRound
    per_op_graphs = False

    def __init__(self, params: CkksParams, mesh, axis: str = "coef"):
        self.impl = params.ntt_impl
        if params.ntt_backend != "fourstep" or params.ntt_impl != cuda_ntt.MXU:
            params = dataclasses.replace(params, ntt_backend="fourstep", ntt_impl=cuda_ntt.MXU)
        super().__init__(params)
        self.mesh, self.axis = mesh, axis
        self.D, self.rank = axis_size(mesh, axis), axis_index(mesh, axis)
        self.group = axis_group(mesh, axis)
        self.n1, self.n2 = self.fntt.n1, self.fntt.n2
        check_shards(self.n1, self.n2, self.D)
        self.chain = self.fntt.tables.streamed
        self.local_n = params.n // self.D
        self._local_perms: dict = {}
        self._graphs = graphs.GraphCache(tied=True)

    def cached_graph(self, key, body, *inputs, scrub: bool = False):
        """``body(*inputs)`` through this context's graph cache, the
        counterpart of the JAX class's ``cached_jit``: ``key`` is the JAX
        key, the inputs (ciphertexts, keys, tensors: this rank's shards) add
        their signatures; collectives run inside the captured graph. Eager
        on the CPU, inside :func:`..utils.graphs.eager` and during another
        capture."""
        return graphs.cached(self._graphs, key, "the sharded composition", body, *inputs,
                             scrub=scrub)

    def ntt(self, a: torch.Tensor, idx: Sequence[int]) -> torch.Tensor:
        """Local coefficients (..., l, N/D), (n1, n2/D) order → local
        evaluations, (n2, n1/D) order."""
        return self._halves(a, idx, True)

    def intt(self, a: torch.Tensor, idx: Sequence[int]) -> torch.Tensor:
        return self._halves(a, idx, False)

    def _halves(self, a, idx, forward):
        sel = list(idx)
        if tuple(a.shape[-2:]) != (len(sel), self.params.n // self.D):
            raise ValueError(f"expected a local shard (..., {len(sel)}, "
                             f"{self.params.n // self.D}), got {tuple(a.shape)}")
        m1, m2 = (self.n1, self.n2) if forward else (self.n2, self.n1)
        y = halves(a.reshape(-1, len(sel), m1, m2 // self.D), self.chain, sel, forward,
                   self.rank, self.D, self.group)
        return y.reshape(a.shape)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a global evaluation-domain tensor (..., N)."""
        return eval_shard(x, self.n1, self.n2, self.rank, self.D)

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """The global evaluation-domain tensor (..., N) from every rank's
        shard (..., N/D): one all-gather over the coef axis."""
        return _gather_full(self, y)

    def local_perm(self, g: int, device) -> torch.Tensor:
        """This rank's n1-column block of the automorphism X → X^g's
        permutation (:meth:`galois_perm`), flat, cached per g and device."""
        key = (g, str(device))
        if key not in self._local_perms:
            pm = self.galois_perm(g, device).reshape(self.n2, self.n1)
            self._local_perms[key] = shard(pm, self.rank, self.D, -1).reshape(-1).contiguous()
        return self._local_perms[key]


# ---------------------------------------------------------------------------
# Boundary layouts: global flat tensors <-> a rank's shard
# ---------------------------------------------------------------------------

def eval_matrix(x: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """Flat evaluation order (..., N) → (..., n2, n1) (shard the last axis)."""
    return x.reshape(x.shape[:-1] + (n2, n1))


def eval_flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[:-2] + (-1,))


def eval_shard(x: torch.Tensor, n1: int, n2: int, index: int, count: int) -> torch.Tensor:
    """Shard ``index`` of ``count`` of a global evaluation-domain tensor
    (..., N): columns [index·n1/count, …) of its (n2, n1) view, flat."""
    return eval_flat(shard(eval_matrix(x, n1, n2), index, count, -1).contiguous())


def eval_unshard(parts, n1: int, n2: int) -> torch.Tensor:
    """The global tensor (..., N) from its shards in rank order."""
    count = len(parts)
    return eval_flat(unshard([eval_matrix(p, n1 // count, n2) for p in parts], -1))


def scheme_view(sch, sctx: ShardedEvalContext):
    """The scheme ``sch`` with its context replaced by ``sctx``, so that the
    FL tools' compositions (``fl.api.server_round``,
    ``change_cipher_domain_batch``, ``aggregate_batch``) run on this rank's
    shards."""
    view = copy.copy(sch)
    view.ctx = sctx
    return view


# ---------------------------------------------------------------------------
# Sharded operations on this rank's shards
# ---------------------------------------------------------------------------

def re_encrypt_sharded(sctx: ShardedEvalContext, ct: Ciphertext,
                       rekey: KeySwitchKey) -> Ciphertext:
    """changeCipherDomain with the key switch run coefficient-sharded over
    the coef axis (bit-equal to the replicated path). ``ct`` and ``rekey``
    are this rank's shards."""
    l = ct.nlimbs

    def body(c, k):
        return ev.with_c0(sctx, c.data[..., 0, :, :], ev.keyswitch(sctx, c.data[..., 1, :, :], k, l),
                          c.scale)

    return sctx.cached_graph(("reenc", l), body, ct, ev.ksk_to_mont(sctx, rekey))


def _gather_full(sctx: ShardedEvalContext, y: torch.Tensor) -> torch.Tensor:
    """One all-gather over coef of a local evaluation-domain poly (..., N/D)
    → the full flat (..., N); split out of the automorphism so that a batch
    of rotations of one poly gathers it once."""
    n1loc = sctx.n1 // sctx.D
    lead = y.shape[:-1]
    g = all_gather_stack(y.reshape(lead + (sctx.n2, n1loc)), sctx.group)  # (D, ..., n2, n1loc)
    return g.movedim(0, -2).reshape(lead + (sctx.n2 * sctx.n1,))


def _perm_local(sctx: ShardedEvalContext, full: torch.Tensor, g: int) -> torch.Tensor:
    """This rank's block of X → X^g applied to a gathered full evaluation
    vector: new[k] = old[perm[k]], k in the rank's columns."""
    return full.index_select(-1, sctx.local_perm(g, full.device))


def _automorphism_local(sctx: ShardedEvalContext, y: torch.Tensor, g: int) -> torch.Tensor:
    """X → X^g on a coefficient-sharded evaluation-domain poly: one
    all-gather, then the rank's slice of the global permutation."""
    return _perm_local(sctx, _gather_full(sctx, y), g)


def _galois_keyswitch_sharded(sctx: ShardedEvalContext, ct: Ciphertext, g: int,
                              key: KeySwitchKey) -> Ciphertext:
    """X → X^g on both components (one all-gather each), then one sharded
    key switch of the permuted c1: one cached graph per (g, l)."""
    l = ct.nlimbs

    def body(c, k):
        c0p = _automorphism_local(sctx, c.data[..., 0, :l, :], g)
        c1p = _automorphism_local(sctx, c.data[..., 1, :l, :], g)
        return ev.with_c0(sctx, c0p, ev.keyswitch(sctx, c1p, k, l), c.scale)

    return sctx.cached_graph(("galois", g, l), body, ct, ev.ksk_to_mont(sctx, key))


def rotate_sharded(sctx: ShardedEvalContext, ct: Ciphertext, r: int,
                   rot_key: KeySwitchKey) -> Ciphertext:
    """EvalRotate with the automorphism and the key switch run
    coefficient-sharded (bit-equal to ``eval.rotate`` on the replicated
    path)."""
    return _galois_keyswitch_sharded(sctx, ct, ev.rot_to_galois(r, sctx.params.n), rot_key)


def conjugate_sharded(sctx: ShardedEvalContext, ct: Ciphertext,
                      conj_key: KeySwitchKey) -> Ciphertext:
    """EvalConj sharded (the automorphism g = 2N − 1)."""
    return _galois_keyswitch_sharded(sctx, ct, 2 * sctx.params.n - 1, conj_key)


def rotate_hoisted_sharded(sctx: ShardedEvalContext, ct: Ciphertext,
                           rotations: Sequence[int], rot_keys: dict) -> list:
    """Hoisted rotations, sharded: one sharded decompose+extend
    (``keyswitch_digits``), the digits' stack and c0 gathered once, then per
    rotation the rank's slice of each permutation and the inner product and
    ModDown on the shard (``eval.rotate_hoisted``'s order); one cached
    graph per tuple of Galois elements and l."""
    l = ct.nlimbs
    gs = tuple(ev.rot_to_galois(r, sctx.params.n) for r in rotations)

    def body(c, *keys):
        digits_full = _gather_full(sctx, ev.keyswitch_digits(sctx, c.data[..., 1, :, :], l))
        c0_full = _gather_full(sctx, c.data[..., 0, :l, :])
        out = []
        for g, key in zip(gs, keys):
            pair = ev.keyswitch_apply(sctx, _perm_local(sctx, digits_full, g), key, l)
            out.append(ev.with_c0(sctx, _perm_local(sctx, c0_full, g), pair, c.scale))
        return tuple(out)

    keys = [ev.ksk_to_mont(sctx, rot_keys[r]) for r in rotations]
    return list(sctx.cached_graph(("hoisted", gs, l), body, ct, *keys))


def fedavg_round_sharded(sctx: ShardedEvalContext, stacks: torch.Tensor, rk12: KeySwitchKey,
                         rk21: KeySwitchKey, scale: float,
                         client_axis: str = "client") -> tuple:
    """The reference server round over a client × coef mesh, on this rank's
    shards. ``stacks``: (local clients, B, 2, l, N/D), this rank's clients
    (block ``axis_index(client)`` of the client axis) and coefficients. PRE
    the non-hub clients into the hub's domain (the hub is the last client,
    the orchestrator's aggregation domain, and is used as it is), a modular
    psum over ``client``, EvalMult(1/n) + rescale, then PRE the average
    back. Returns the (average, average re-encrypted) data (B, 2, l', N/D),
    the same on every client rank. One cached graph per (client axis,
    clients, B, l, scale)."""
    mesh = sctx.mesh
    local_clients, l = stacks.shape[0], stacks.shape[-2]
    n_clients = local_clients * axis_size(mesh, client_axis)
    base = axis_index(mesh, client_axis) * local_clients
    group = axis_group(mesh, client_axis)

    def body(st_all, k12, k21):
        q, _, _ = sctx.limb_consts(sctx.q_idx(l), st_all.device)
        acc = None
        for c in range(local_clients):
            st = st_all[c]
            if base + c != n_clients - 1:
                st = re_encrypt_sharded(sctx, Ciphertext(st, scale), k12).data
            acc = st if acc is None else modadd(acc, st, q)
        tot = psum_mod(acc, q, group)
        avg = ev.mult_scalar(sctx, Ciphertext(tot, scale), 1.0 / n_clients)
        return avg.data, re_encrypt_sharded(sctx, avg, k21).data

    key = ("fedavg", client_axis, n_clients, stacks.shape[1], l, float(scale))
    return sctx.cached_graph(key, body, stacks, ev.ksk_to_mont(sctx, rk12),
                             ev.ksk_to_mont(sctx, rk21))
