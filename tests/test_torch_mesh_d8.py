"""A coef axis of D = 8 at N = 2^12 (n1 = n2 = 64, shards of 8 columns and 8
rows: kernels 4 and 5's narrow tiles on the card, their plain versions
here), the shape of the JAX package's ``SCALING_MODEL.json`` row for D = 8.

One 8-rank ``gloo`` job runs ``tests/torch_dist_worker.py``'s ``mesh_d8``
scenario (torch, numpy and the port only): ``ShardedNtt`` over the QP
chain and ``fedavg_round_sharded`` on a client 1 × coef 8 mesh, on
``bench_scaling.py``'s round inputs (2D = 16 ciphertexts a client, uniform
residues, uniform key residues). The parent stitches the ranks' shards and
holds them, bit for bit, to the JAX ``ShardedNtt`` and
``fedavg_round_sharded`` on the conftest's 8-device virtual CPU mesh (the
job runs beside the JAX compile), and the collectives one round issues to
the committed model's D = 8 row in ops and bytes."""

import concurrent.futures
import dataclasses
import json
import os

import numpy as np
import torch

from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.ckks.params import CkksContext
from ppqsflhe_tpu_torch.parallel import multihost
from ppqsflhe_tpu_torch.parallel import sharded_scheme as ss

N = 1 << 12
D = 8
B = 2 * D            # ciphertexts a client: bench_scaling.py's round_cts at D = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 300
HLO = {"all_to_all": "all-to-all", "all_reduce": "all-reduce", "all_gather": "all-gather"}


def _jax_reference(jp, z):
    """The JAX package's ShardedNtt and fedavg_round_sharded on 8 virtual
    CPU devices, on the same inputs."""
    import jax
    import jax.numpy as jnp

    from ppqsflhe_tpu.ops.sharded_ntt import ShardedNtt as JaxShardedNtt
    from ppqsflhe_tpu.parallel import sharded_scheme as jss
    from ppqsflhe_tpu.parallel.mesh import make_mesh as jax_mesh

    sctx = jss.ShardedEvalContext(jp, jax_mesh({"client": 1, "coef": D}))
    L, n1, n2 = len(sctx.moduli_qp), sctx.n1, sctx.n2
    sn = JaxShardedNtt(N, sctx.moduli_qp, sctx.basis.psis, jax_mesh({"coef": D}))
    u = lambda a: jnp.asarray(np.asarray(a).view(np.uint64))
    ntt = jax.jit(sn.ntt)
    intt = jax.jit(sn.intt)
    ref = {"ntt": np.stack([np.asarray(ntt(u(p).reshape(L, n1, n2))) for p in z["x"]]),
           "intt": np.stack([np.asarray(intt(u(p).reshape(L, n2, n1))) for p in z["y"]])}
    avg, back = jss.fedavg_round_sharded(sctx, u(z["stacks"]), u(z["rk12"]), u(z["rk21"]),
                                         float(z["scale"]))
    ref["avg"], ref["back"] = np.asarray(avg), np.asarray(back)
    return ref


def test_d8_sharded_ntt_and_round_equal_jax(tmp_path):
    """Every rank's shard of the forward and inverse ShardedNtt and of the
    round's average and re-encrypted average, stitched, equals the JAX
    package's bit for bit; one round issues the collectives of
    SCALING_MODEL.json's D = 8 row (11 all-to-alls, one all-reduce, their
    bytes)."""
    from ppqsflhe_tpu.ckks.params import CkksParams as JaxParams

    jp = JaxParams.generate(n=N, mult_depth=2, scale_bits=40, dnum=2, ntt_backend="fourstep")
    params = convert.params(dataclasses.asdict(jp))
    ctx = CkksContext(params)
    rng = np.random.default_rng(0)
    l, qp = params.num_q, ctx.moduli_qp
    nd = len(ctx.digit_groups)
    q_col = lambda ms: np.array(ms, np.uint64)[:, None]
    z = dict(params=json.dumps(convert.params_fields(params)), scale=np.array(params.scale),
             stacks=rng.integers(0, 1 << 59, (2, B, 2, l, N), dtype=np.uint64)
             % q_col(params.q_moduli),
             rk12=rng.integers(0, 1 << 59, (nd, 2, len(qp), N), dtype=np.uint64) % q_col(qp),
             rk21=rng.integers(0, 1 << 59, (nd, 2, len(qp), N), dtype=np.uint64) % q_col(qp),
             x=rng.integers(0, 1 << 59, (2, len(qp), N), dtype=np.uint64) % q_col(qp),
             y=rng.integers(0, 1 << 59, (2, len(qp), N), dtype=np.uint64) % q_col(qp))
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, **{k: v.view(np.int64) if getattr(v, "dtype", None) == np.uint64 else v
                        for k, v in z.items()})
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        job = pool.submit(multihost.spawn_ranks, ["tests/torch_dist_worker.py", "mesh_d8",
                                                  str(inputs), str(tmp_path)], D, "cpu",
                          timeout=WORKER_TIMEOUT_S)
        ref = _jax_reference(jp, z)
        job.result()
    res = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(D)]
    n1, n2, L = ctx.fntt.n1, ctx.fntt.n2, len(qp)
    assert (n1 // D, n2 // D) == (8, 8)
    fwd = np.concatenate([r["ntt"] for r in res], -1).view(np.uint64)
    np.testing.assert_array_equal(fwd.reshape(2, L, n2, n1), ref["ntt"])
    inv = np.concatenate([r["intt"] for r in res], -1).view(np.uint64)
    np.testing.assert_array_equal(inv.reshape(2, L, n1, n2), ref["intt"])
    for part in ("avg", "back"):
        got = ss.eval_unshard([torch.from_numpy(r[part]) for r in res], n1, n2).numpy()
        np.testing.assert_array_equal(got.view(np.uint64), ref[part])
    with open(os.path.join(REPO, "SCALING_MODEL.json")) as f:
        want = json.load(f)["collective_bytes_per_round"][str(D)]
    for r in res:
        got = json.loads(str(r["colls"]))
        for op, v in got.items():
            assert v == want[HLO[op]], (op, v, want[HLO[op]])
