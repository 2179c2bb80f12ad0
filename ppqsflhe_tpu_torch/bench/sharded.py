"""The sharded server round: the twin of ``bench_sharded.py``.

The workload of :mod:`.server_round` (``bench.py``: 2 clients × 27
ciphertexts at N=2^14 on ``CkksParams.generate(n=2^14, mult_depth=2,
scale_bits=40, dnum=2)``), run through
:class:`..parallel.sharded_scheme.ShardedEvalContext` over a client 1 ×
coef D mesh of the process group (D = the world size; on one card a
one-rank NCCL group): every transform is the per-shard kernel pair 4 + 5
around a tiled all-to-all (one that moves nothing at D=1), every key
switch kernels 2 and 3 on the shards. The round is ``fl.api.server_round``
composed over the sharded context, in the schedule ``PPQSFLHE_BENCH_LAZY``
names (``bench_sharded.py:73-112``). Its outputs must equal the replicated
round's on this rank's shard bit for bit, and decrypt (gathered) to the
payload within 1e-3.

Timed as :mod:`.server_round` times the replicated round (the marginal
between 20 and 60 chained rounds, :mod:`.timing`), the replicated round
beside it, one sharded round's device time, enqueue and idle share on
stderr. ``bench_sharded.py`` times a compiled round (one ``jit(shard_map)``
over a ``lax.scan``), so the sharded round is also captured whole
(:class:`..fl.compiled.CompiledRound` on the sharded view: one CUDA graph a
rank with its NCCL collectives inside) and timed the same way under
:mod:`.server_round`'s ``compiled_*`` keys; a replay on the clients' shards
must be bit-equal to the eager sharded round (``compiled_equal``). Run on
the card::

    python -m ppqsflhe_tpu_torch.bench.sharded

It prints one JSON line with ``bench_sharded.py``'s keys (``"metric":
"sharded_round_ms"``, ``value``: the eager round's, ``replicated_ms``,
``lazy``, ``impl``) plus ``"card"``, the collectives of one round, the
gates and the ``compiled_*`` keys. A compiled round that differs from the
eager one raises after the line, as a failed gate does. ``--device cpu``
runs the same on a one-rank ``gloo`` group, untimed (``value`` and the
``compiled_*`` keys None: no graph is captured), at any ``--n``.
"""

from __future__ import annotations

import argparse
import json
import time
import types

import numpy as np
import torch
import torch.distributed as dist

from ..ckks.scheme import CkksScheme
from ..ckks.types import Ciphertext, KeySwitchKey
from ..fl.api import server_round
from ..parallel import mesh as pmesh
from ..parallel.sharded_scheme import ShardedEvalContext, scheme_view
from . import server_round as twin
from . import timing
from .timing import card_line

METRIC = "sharded_round_ms"


def local_world(sch: CkksScheme, sctx: ShardedEvalContext, w):
    """This rank's shards of the world ``w``'s rekeys and ciphertexts."""
    key = lambda k: KeySwitchKey(sctx.local(k.data), k.mont)
    loc = lambda ct: Ciphertext(sctx.local(ct.data), ct.scale)
    return types.SimpleNamespace(rk12=key(w.rk12), rk21=key(w.rk21), ct1=loc(w.ct1),
                                 ct2=loc(w.ct2))


def round_fns(sch: CkksScheme, sctx: ShardedEvalContext, w, lazy: int) -> tuple:
    """(sharded round, replicated round), each a callable on the two
    clients' data, returning [average, average re-encrypted]; the sharded
    one takes and gives this rank's shards."""
    view = scheme_view(sch, sctx)
    wl = local_world(sch, sctx, w)
    scale = w.ct1.scale

    def sharded(d1, d2):
        return [c.data for c in server_round(view, Ciphertext(d1, scale), Ciphertext(d2, scale),
                                             wl.rk12, wl.rk21, lazy)]

    def replicated(d1, d2):
        return [c.data for c in server_round(sch, Ciphertext(d1, scale), Ciphertext(d2, scale),
                                             w.rk12, w.rk21, lazy)]

    return sharded, replicated


def bench(device="cuda", lazy: int = 4, n: int = twin.N, count: int = twin.N_CTS,
          reps: int = 3, out=print) -> dict:
    """On an initialized process group: set up, run the sharded round once
    against the replicated round (bit for bit on this rank's shard) and the
    payload (< 1e-3), time both on the card, print the JSON line with
    ``out`` and return it; raises after printing when a gate fails."""
    device = torch.device(device)
    card = card_line() if device.type == "cuda" else None
    t0 = time.perf_counter()
    sch = CkksScheme(twin.params(n=n), device=device)
    vecs = twin.payload(sch.encoder.slots, count)
    w = twin.world(sch, vecs)
    mesh = pmesh.make_mesh({"client": 1, "coef": dist.get_world_size()}, device.type)
    sctx = ShardedEvalContext(sch.params, mesh)
    sharded, replicated = round_fns(sch, sctx, w, lazy)
    d1, d2 = sctx.local(w.ct1.data), sctx.local(w.ct2.data)
    pmesh.reset_collectives()
    got = sharded(d1, d2)
    colls = pmesh.read_collectives()
    want = replicated(w.ct1.data, w.ct2.data)
    bit_equal = all(torch.equal(g, sctx.local(x)) for g, x in zip(got, want))
    avg, back = server_round(sch, w.ct1, w.ct2, w.rk12, w.rk21, lazy)
    full = [Ciphertext(sctx.gather(g), c.scale) for g, c in zip(got, (avg, back))]
    errs = twin.check(sch, w, vecs, *full)
    t_setup = time.perf_counter() - t0
    err = max(errs.values())
    correct = bool(bit_equal and np.isfinite(err) and err < twin.ERR_GATE)
    m, rep_ms, c = {"ms": None}, None, dict.fromkeys(twin.COMPILED_KEYS)
    if device.type == "cuda":
        work = d1.clone()
        unit = lambda: sharded(work, d2)
        m = timing.marginal_carried_ms(unit, work, twin.R_LO, twin.R_HI, reps)
        m.update(timing.unit_report(f"sharded round lazy={lazy}", unit, m["ms"], card))
        work_r = w.ct1.data.clone()
        rep_ms = timing.marginal_carried_ms(lambda: replicated(work_r, w.ct2.data), work_r,
                                            twin.R_LO, twin.R_HI, reps)["ms"]
        c = twin.measure_compiled(scheme_view(sch, sctx), local_world(sch, sctx, w), lazy,
                                  card, reps, f"compiled sharded round lazy={lazy}")
    result = {"metric": METRIC, "value": m["ms"], "unit": f"ms_per_round_D{sctx.D}_mesh",
              "replicated_ms": rep_ms, "lazy": lazy, "impl": sctx.impl, "use_pallas_ks": True,
              "n": n, "ciphertexts": count, "devices": dist.get_world_size(),
              "bit_equal": bit_equal, "correct": correct, "err": err,
              "out_limbs": back.nlimbs, "collectives": colls, "setup_seconds": t_setup,
              **{k: v for k, v in m.items() if k != "ms"}, **c, "card": card}
    out(json.dumps(result))
    if not correct:
        raise AssertionError(f"sharded round lazy={lazy}: bit-equal {bit_equal}, decrypt error "
                             f"{errs} (gate {twin.ERR_GATE})")
    if c["compiled_equal"] is False:
        raise AssertionError(f"sharded round lazy={lazy}: the compiled round differs from the "
                             "eager sharded round")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=twin.N)
    ap.add_argument("--count", type=int, default=twin.N_CTS)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("sharded bench: needs a CUDA GPU (or --device cpu)")
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device(args.device)
    _, _, lazy = twin.settings()
    with pmesh.single_process_group(device):
        bench(device, lazy, args.n, args.count)


if __name__ == "__main__":
    main()
