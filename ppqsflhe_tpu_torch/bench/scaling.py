"""Weak scaling of the mesh-parallel paths: the twin of ``bench_scaling.py``.

Per-rank work is fixed while the rank count D grows, on the three paths of
the JAX bench:

1. the coefficient-sharded NTT (:class:`..ops.sharded_ntt.ShardedNtt`, one
   all-to-all per transform): D polys of 4 limbs
   (``first_prime_down(59, 2N)`` + three 40-bit primes) at N=2^14, at every
   D that divides n1 = n2 = 128;
2. the multikey aggregation (:func:`..ckks.multikey.aggregate_sharded`, one
   modular psum): 2 clients a rank, 8 ciphertexts each, on the N=256
   depth-1 chain, the JAX bench's (``bench_scaling.py:186-201``; its
   rescale runs kernel 1 at m = 16);
3. the sharded server round (``fedavg_round_sharded`` on a client 1 × coef
   D mesh): 2D ciphertexts per client at N=2^12, depth 2, dnum 2 — the
   round of ``SCALING_MODEL.json`` — at every D that divides n1 = n2 = 64
   (D = 8 runs kernels 4 and 5 on 8-column shards), and the collectives it
   issues, ops and bytes per kind from :data:`..parallel.mesh.collectives`
   (the counterpart of ``bench_scaling.py``'s HLO scrape and
   ``diff_model``).

Each D runs as its own job of D ranks (:func:`..parallel.multihost.spawn_ranks`):
``gloo`` on the CPU (``--device cpu``: the ranks share this host's cores, so
times grow with D even at perfect weak scaling), NCCL with one rank per
card on GPUs, where only the D up to the cards present run (one H100: D=1;
the JSON's ``devices`` and ``skipped`` say so). Times are the best of 3
host-clock windows of ``--reps`` calls, each closed by a device
synchronize and a barrier. The collectives are compared with the JAX
package's committed model (``model_diff``): at D ≥ 2 the port issues the
all-to-alls and the all-reduce that XLA compiled, with the same payload
bytes; at D = 1 XLA drops the all-to-alls that move nothing, and the port
keeps them. The root ``SCALING_MODEL.json`` is the JAX package's and is not
written. Prints one JSON line with the JAX bench's keys plus ``"card"``::

    python -m ppqsflhe_tpu_torch.bench.scaling [--devs 1,2,4,8] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..ckks import multikey
from ..ckks.params import CkksContext, CkksParams
from ..ckks.types import KeySwitchKey
from ..core import primes
from ..ops.sharded_ntt import ShardedNtt
from ..parallel import mesh as pmesh
from ..parallel import multihost
from ..parallel.sharded_scheme import ShardedEvalContext, fedavg_round_sharded
from .timing import card_line

N_NTT, LIMBS, N_AGG, N_ROUND = 1 << 14, 4, 1 << 8, 1 << 12
MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "SCALING_MODEL.json")
HLO_NAMES = {"all_to_all": "all-to-all", "all_reduce": "all-reduce", "all_gather": "all-gather"}


def _best_ms(fn, reps: int, device) -> float:
    fn()
    best = None
    for _ in range(3):
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
        dt = (time.perf_counter() - t0) / reps * 1e3
        best = dt if best is None else min(best, dt)
    return best


def _residues(rng, moduli, shape):
    """Uniform residues int64[*shape[:-1], len(moduli), shape[-1]]."""
    return np.stack([rng.integers(0, q, shape, dtype=np.uint64) for q in moduli],
                    axis=-2).view(np.int64)


def run_one(device, reps: int, n_ntt: int = N_NTT) -> dict:
    """This rank's part of the three weak-scaling paths at D = the world
    size; returns the row rank 0 prints. A path whose transform D does not
    divide (the NTT: n1 = n2 = 128 at N=2^14; the round: 64 at N=2^12) is
    not run, and its entries are None."""
    D = dist.get_world_size()
    rng = np.random.default_rng(0)
    put = lambda a: torch.as_tensor(a, device=device)
    row = {"devices": D, "ntt_ms": None, "round_ms": None, "round_cts": 2 * D,
           "collective_bytes": None}

    # 1. the coefficient-sharded NTT: D polys per rank
    moduli = [primes.first_prime_down(59, 2 * n_ntt)] + [
        primes.first_prime_down(40 + i, 2 * n_ntt) for i in range(LIMBS - 1)]
    psis = [primes.root_of_unity(2 * n_ntt, q) for q in moduli]
    n1 = 1 << ((n_ntt.bit_length() - 1) // 2)
    if n1 % D == 0:
        sn = ShardedNtt(n_ntt, moduli, psis, pmesh.make_mesh({"coef": D}, device.type))
        c = sn.n2 // D
        x = put(_residues(rng, moduli, (D, sn.n1 * c)).reshape(D, LIMBS, sn.n1, c))
        row["ntt_ms"] = _best_ms(lambda: sn.ntt(x), reps, device)

    # 2. multikey aggregation over the client axis: 2 clients a rank
    p1 = CkksParams.generate(n=N_AGG, mult_depth=1, scale_bits=40, dnum=2)
    ctx1 = CkksContext(p1)
    stack = put(_residues(rng, p1.q_moduli, (2, 8, 2, N_AGG)))
    cmesh = pmesh.make_mesh({"client": D}, device.type)
    row["agg_ms"] = _best_ms(
        lambda: multikey.aggregate_sharded(ctx1, stack, cmesh, p1.scale, 2 * D), reps, device)

    # 3. the sharded round, client 1 × coef D, 2D ciphertexts per client
    if (1 << ((N_ROUND.bit_length() - 1) // 2)) % D:
        return row
    p2 = CkksParams.generate(n=N_ROUND, mult_depth=2, scale_bits=40, dnum=2)
    sctx = ShardedEvalContext(p2, pmesh.make_mesh({"client": 1, "coef": D}, device.type))
    B, nd = 2 * D, len(sctx.digit_groups)
    stacks = sctx.local(put(_residues(rng, p2.q_moduli, (2, B, 2, N_ROUND))))
    rk = [KeySwitchKey(sctx.local(put(_residues(rng, sctx.moduli_qp, (nd, 2, N_ROUND)))))
          for _ in range(2)]
    rnd = lambda: fedavg_round_sharded(sctx, stacks, rk[0], rk[1], float(p2.scale))
    rnd()
    pmesh.reset_collectives()
    rnd()
    row["collective_bytes"] = {HLO_NAMES[k]: v for k, v in pmesh.read_collectives().items()}
    row["round_ms"] = _best_ms(rnd, max(1, reps // 2), device)
    return row


def model_diff(rows: dict) -> dict:
    """Per D, the collectives where the port's counts differ from the JAX
    package's committed ``SCALING_MODEL.json`` (empty: none)."""
    with open(MODEL) as f:
        model = json.load(f)["collective_bytes_per_round"]
    out = {}
    for d, row in rows.items():
        want = model.get(str(d))
        if want is None or row["collective_bytes"] is None:
            out[d] = "no model entry" if want is None else "round not run"
            continue
        out[d] = [f"{op}: model {want[op]} vs port {got}"
                  for op, got in row["collective_bytes"].items()
                  if want.get(op) != got and not (d == 1 and op == "all-to-all")]
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devs", default="1,2,4,8")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--n-ntt", type=int, default=N_NTT)
    ap.add_argument("--one", action="store_true", help="run as one rank of a job")
    args = ap.parse_args(argv)
    cuda = torch.device(args.device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("scaling bench: needs a CUDA GPU (or --device cpu)")
    if args.one:
        multihost.initialize(device=args.device)
        device = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device(
            "cpu")
        try:
            row = run_one(device, args.reps, args.n_ntt)
        finally:
            pmesh.destroy_process_group()
        if os.environ["RANK"] == "0":
            print(json.dumps(row), flush=True)
        return
    devs = [int(d) for d in args.devs.split(",")]
    cards = torch.cuda.device_count() if cuda else None
    run = [d for d in devs if not cuda or d <= cards]
    rows = {}
    for d in run:
        outs = multihost.spawn_ranks(
            ["-m", "ppqsflhe_tpu_torch.bench.scaling", "--one", "--device", args.device,
             "--reps", str(args.reps), "--n-ntt", str(args.n_ntt)], d, args.device)
        rows[d] = json.loads(outs[0].strip().splitlines()[-1])
    d0, dmax = run[0], run[-1]
    ratio = lambda key: (None if rows[dmax][key] is None or rows[d0][key] is None
                         else rows[d0][key] / rows[dmax][key])
    print(json.dumps({
        "metric": "weak_scaling_efficiency_ntt",
        "value": ratio("ntt_ms"),
        "round_value": ratio("round_ms"),
        "unit": "fraction", "devices": run, "skipped": [d for d in devs if d not in run],
        "platform": "gpu" if cuda else "cpu",
        "ntt_ms": {d: r["ntt_ms"] for d, r in rows.items()},
        "agg_ms": {d: r["agg_ms"] for d, r in rows.items()},
        "round_ms": {d: r["round_ms"] for d, r in rows.items()},
        "round_cts": {d: r["round_cts"] for d, r in rows.items()},
        "collective_bytes": {d: r["collective_bytes"] for d, r in rows.items()},
        "model_diff": model_diff(rows),
        "note": (f"one rank per card, {cards} card(s): D above that not run" if cuda else
                 "CPU ranks on one host's cores: times grow with D even at perfect weak "
                 "scaling; no device number"),
        "card": card_line() if cuda else None}))


if __name__ == "__main__":
    main()
