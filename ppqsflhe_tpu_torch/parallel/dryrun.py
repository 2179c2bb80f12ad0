"""The multi-rank dry run: the twins of ``__graft_entry__.py``'s ``entry``
and ``dryrun_multichip`` (``:31-211``).

- :func:`entry` returns the homomorphic FedAvg server step (PRE key switch,
  EvalAdd, EvalMult(1/2) + rescale) and example arguments at N=2^12.
- :func:`dryrun_multichip` is what every rank of an n-rank job runs: a
  client × coef mesh (client 2 where n is even, else 1), then
  1. the aggregation step: each rank's clients folded mod q, a modular
     psum over ``client``, EvalMult(1/N) + rescale on the coef shards
     (the JAX step ran it at N=max(64, 4·coef); here N=2^12, whose n1 = 64
     takes up to 4 coef ranks), bit-equal to the replicated step;
  2. a data-parallel GRU step: gradients of each client rank's batch
     shard, an ``all_reduce`` mean over ``client``, one Adam step, equal to
     one step on the whole batch;
  3. the sharded server round (``fedavg_round_sharded``) on the N=2^12
     FLEXIBLEAUTOEXT chain (Q = 60/40/40 + 20 bits), two clients encrypting
     v and −v, whose average decrypts to 0;
  4. one sharded rotation, decrypted against the rotated slots.

Run ``python -m ppqsflhe_tpu_torch.parallel.dryrun [n] [--device cpu|cuda]``:
it calls ``entry()``'s step once, then starts n ranks (on the card one per
GPU; ``--device cpu``: ``gloo``). Under ``torchrun`` (``RANK`` set) the
process is one rank.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from ..ckks import eval as ev
from ..ckks.multikey import fold_local
from ..ckks.params import CkksParams
from ..ckks.scheme import CkksScheme
from ..ckks.types import Ciphertext, KeySwitchKey
from ..train import gru
from ..train.trainer import make_optimizer
from . import multihost
from .mesh import axis_group, axis_index, destroy_process_group, make_mesh, psum_mod, shard
from .sharded_scheme import ShardedEvalContext, fedavg_round_sharded, rotate_sharded

N_RING = 1 << 12
ERR_GATE = 1e-3


def _scheme(device, depth: int = 2, extra_mod_bits: int = 0) -> CkksScheme:
    return CkksScheme(CkksParams.generate(n=N_RING, mult_depth=depth, scale_bits=40, dnum=2,
                                          extra_mod_bits=extra_mod_bits), device=device)


def _keys(sch: CkksScheme, seed: int):
    gen = torch.Generator().manual_seed(seed)
    sk1, pk1 = sch.keygen(gen)
    sk2, pk2 = sch.keygen(gen)
    return gen, sk1, pk1, sk2, pk2


def entry(device="cuda"):
    """(fn, example_args): the FedAvg server step on two clients' ciphertexts
    and the rekey 1 → 2 (Montgomery form), all tensors on ``device``."""
    sch = _scheme(device)
    gen, sk1, pk1, sk2, pk2 = _keys(sch, 0)
    rk12 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk1, pk2, gen))
    v = np.linspace(-1, 1, sch.encoder.slots)
    ct1 = sch.encrypt_values(pk1, v, gen)
    ct2 = sch.encrypt_values(pk2, -v, gen)
    scale = ct1.scale

    def fedavg_step(d1, d2, rk):
        """PRE d1 into client 2's domain, then (d1 + d2)·0.5 with rescale."""
        pair = ev.keyswitch(sch.ctx, d1[1], KeySwitchKey(data=rk, mont=True), d1.shape[-2])
        tot = ev.add(sch.ctx, ev.with_c0(sch.ctx, d1[0], pair, scale), Ciphertext(d2, scale))
        return ev.mult_scalar(sch.ctx, tot, 0.5).data

    return fedavg_step, (ct1.data, ct2.data, rk12.data)


def _aggregation_step(mesh, n_client: int, device) -> tuple:
    """Step 1: the client × coef aggregation of synthetic residues, held
    bit-equal to the replicated step; returns the local output's shape."""
    sch = _scheme(device, depth=1)
    sctx = ShardedEvalContext(sch.params, mesh)
    L, n, scale = sch.params.num_q, sch.params.n, sch.params.scale
    n_clients = 2 * n_client
    rng = np.random.default_rng(0)
    stack = torch.as_tensor(np.stack([
        np.stack([rng.integers(0, q, (2, n), dtype=np.uint64).view(np.int64)
                  for q in sch.params.q_moduli], axis=1) for _ in range(n_clients)]),
        device=device)                                       # (clients, 2, L, N)
    q, _, _ = sch.ctx.limb_consts(sch.ctx.q_idx(L), device)
    local = sctx.local(shard(stack, axis_index(mesh, "client"), n_client, 0))
    acc = psum_mod(fold_local(local, q), q, axis_group(mesh, "client"))
    out = ev.mult_scalar(sctx, Ciphertext(acc, scale), 1.0 / n_clients).data
    want = ev.mult_scalar(sch.ctx, Ciphertext(fold_local(stack, q), scale),
                          1.0 / n_clients).data
    if out.shape != (2, L - 1, n // sctx.D) or not torch.equal(out, sctx.local(want)):
        raise AssertionError(f"sharded aggregation step differs from the replicated one "
                             f"(local shape {tuple(out.shape)})")
    return tuple(out.shape)


def _gru_step(mesh, n_client: int, device) -> float:
    """Step 2: one data-parallel GRU step (gradients of the rank's batch
    shard, all_reduce mean over client, Adam), against one step on the
    whole batch; returns the largest parameter difference."""
    rng = np.random.default_rng(0)
    B, T, F = 2 * n_client, 8, 7
    x = torch.as_tensor(rng.normal(size=(B, T, F)), dtype=torch.float32, device=device)
    y = torch.as_tensor(rng.normal(size=(B,)), dtype=torch.float32, device=device)
    init = [p.to(device) for p in gru.init_params(torch.Generator().manual_seed(0), F)]

    def step(xb, yb, reduce):
        model = gru.Model(init)
        opt = make_optimizer(model)
        loss = torch.mean((model(xb) - yb) ** 2)
        loss.backward()
        if reduce:
            group = axis_group(mesh, "client")
            for p in model.parameters():
                dist.all_reduce(p.grad, group=group)
                p.grad /= n_client
        opt.step()
        return [p.detach() for p in model.parameters()]

    c = axis_index(mesh, "client")
    got = step(shard(x, c, n_client, 0), shard(y, c, n_client, 0), True)
    want = step(x, y, False)
    diff = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if not diff < 1e-5:
        raise AssertionError(f"data-parallel GRU step off the whole-batch step by {diff}")
    return diff


def _round_and_rotation(mesh, n_client: int, device) -> str:
    """Steps 3 and 4 on the N=2^12 FLEXIBLEAUTOEXT chain."""
    sch = _scheme(device, extra_mod_bits=20)
    sctx = ShardedEvalContext(sch.params, mesh)
    gen, sk1, pk1, sk2, pk2 = _keys(sch, 0)
    rk12 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk1, pk2, gen))
    rk21 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk2, pk1, gen))
    v = np.linspace(-1, 1, sch.encoder.slots)
    c1 = sch.encrypt_values(pk1, v, gen)
    c2 = sch.encrypt_values(pk2, -v, gen)
    key = lambda k: KeySwitchKey(sctx.local(k.data), k.mont)
    stacks = torch.stack([c1.data[None], c2.data[None]])          # (2 clients, 1, 2, L, N)
    local = sctx.local(shard(stacks, axis_index(mesh, "client"), n_client, 0))
    agg, back = fedavg_round_sharded(sctx, local, key(rk12), key(rk21), c1.scale)
    got = sch.decrypt(sk2, Ciphertext(sctx.gather(agg[0]), c1.scale))
    err = float(np.abs(got).max())
    if not err < ERR_GATE:
        raise AssertionError(f"the FedAvg of v and -v decrypts {err} away from 0")
    rot_key = sch.rotation_key_gen(sk2, [1], gen)[1]
    rot = rotate_sharded(sctx, Ciphertext(sctx.local(c2.data), c2.scale), 1, key(rot_key))
    got_r = sch.decrypt(sk2, Ciphertext(sctx.gather(rot.data), rot.scale))
    err_r = float(np.abs(got_r - np.roll(-v, -1)).max())
    if not err_r < ERR_GATE:
        raise AssertionError(f"sharded rotation off by {err_r}")
    return (f"N={N_RING} L={sch.params.num_q}: agg {tuple(agg.shape)} decrypts to 0 "
            f"({err:.1e}), back {tuple(back.shape)}, rotation ({err_r:.1e})")


def dryrun_multichip(n_ranks: int, device="cuda") -> str:
    """The dry run's body on this rank of an initialized ``n_ranks`` job;
    returns its summary line."""
    if dist.get_world_size() != n_ranks:
        raise ValueError(f"need {n_ranks} ranks, the job has {dist.get_world_size()}")
    device = torch.device(device)
    n_client = 2 if n_ranks % 2 == 0 else 1
    n_coef = n_ranks // n_client
    mesh = make_mesh({"client": n_client, "coef": n_coef}, device.type)
    shape = _aggregation_step(mesh, n_client, device)
    diff = _gru_step(mesh, n_client, device)
    note = _round_and_rotation(mesh, n_client, device)
    return (f"[dryrun_multichip] ok on {n_ranks} ranks (mesh client={n_client} x "
            f"coef={n_coef}, ring N={N_RING}, agg out local shape {shape}, data-parallel GRU "
            f"step within {diff:.1e} of the whole batch, sharded keyswitch round: {note})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun: needs a CUDA GPU (or --device cpu)")
    if "RANK" in os.environ:
        multihost.initialize(device=args.device)
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.device(args.device).type == "cuda" else torch.device("cpu"))
        try:
            line = dryrun_multichip(args.n, device)
        finally:
            destroy_process_group()
        if os.environ["RANK"] == "0":
            print(line, flush=True)
        return
    fn, fargs = entry(args.device)
    print(f"entry() ok: {tuple(fn(*fargs).shape)}", flush=True)
    outs = multihost.spawn_ranks(["-m", "ppqsflhe_tpu_torch.parallel.dryrun", str(args.n),
                                  "--device", args.device], args.n, args.device)
    print(outs[0].strip().splitlines()[-1])


if __name__ == "__main__":
    main()
