"""One rank of the port's multi-rank CPU tests (``gloo``), started by
``tests/test_torch_parallel.py``, ``tests/test_torch_multihost.py``,
``tests/test_torch_mesh_d8.py``, ``tests/test_torch_mesh_16.py``,
``tests/test_torch_multikey.py`` and ``tests/test_torch_mesh_graphs.py`` as

    python tests/torch_dist_worker.py <scenario> <in.npz> <out_dir>

with the job in the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``). It imports torch, numpy and the port only: the parent
computes the JAX references. Inputs are global arrays; each rank writes its
own results to ``<out_dir>/rank<r>.npz``.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from ppqsflhe_tpu_torch import convert  # noqa: E402
from ppqsflhe_tpu_torch.ckks import multikey  # noqa: E402
from ppqsflhe_tpu_torch.ckks import threshold as th  # noqa: E402
from ppqsflhe_tpu_torch.ckks.params import CkksContext  # noqa: E402
from ppqsflhe_tpu_torch.ckks.types import Ciphertext, KeySwitchKey  # noqa: E402
from ppqsflhe_tpu_torch.ops.sharded_ntt import ShardedNtt  # noqa: E402
from ppqsflhe_tpu_torch.parallel import mesh as pm  # noqa: E402
from ppqsflhe_tpu_torch.parallel import multihost  # noqa: E402
from ppqsflhe_tpu_torch.parallel import sharded_scheme as ss  # noqa: E402

# limb subsets the sharded round transforms (l = 3 and 2 on the 3 + 2 chain)
SUBSETS = ((0, 1, 2), (2, 3, 4), (0, 1, 3, 4), (3, 4), (2,), (0, 1))
ROTS = (1, -3)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _layouts(D):
    """(client, coef) meshes of the round at D ranks."""
    return ((1, 2), (2, 1)) if D == 2 else ((2, D // 2),)


def parallel(z, out):
    """Every check of tests/test_torch_parallel.py on this rank."""
    D, r = dist.get_world_size(), dist.get_rank()
    ctx_params = convert.params(json.loads(str(z["params"])))
    ctx = CkksContext(ctx_params)
    n1, n2, moduli = ctx.fntt.n1, ctx.fntt.n2, ctx.moduli_qp
    coef = pm.make_mesh({"client": 1, "coef": D}, "cpu")

    # the tiled all-to-all against its one-process model
    xs = [torch.arange(3 * 8 * D * 4 * D, dtype=torch.int64).reshape(3, 8 * D, 4 * D) * (k + 1)
          for k in range(D)]
    got = pm.all_to_all_tiled(xs[r], pm.axis_group(coef, "coef"), 1, 2)
    out["a2a_ok"] = np.array(torch.equal(got, pm.exchange_tiled(xs, 1, 2)[r]))

    # ShardedNtt over the whole QP chain: coefficient blocks (n1, n2/D)
    sn = ShardedNtt(ctx_params.n, moduli, ctx.basis.psis, coef)
    x = _t(z["x_ntt"]).reshape(-1, len(moduli), n1, n2)
    pm.reset_collectives()
    y = sn.ntt(pm.shard(x, r, D, -1).contiguous())
    out["ntt_a2a_ops"] = np.array(pm.read_collectives()["all_to_all"]["ops"])
    out["ntt"] = y.numpy()
    out["ntt_back"] = sn.intt(y).numpy()
    out["intt"] = sn.intt(pm.shard(x.reshape(-1, len(moduli), n2, n1), r, D, -1)
                          .contiguous()).numpy()

    # the sharded context's transforms at the round's limb subsets
    sctx = ss.ShardedEvalContext(ctx_params, coef)
    xe = _t(z["x_ntt"])
    for i, idx in enumerate(SUBSETS):
        sub = xe[..., list(idx), :]
        loc_c = pm.shard(sub.reshape(sub.shape[:-1] + (n1, n2)), r, D, -1).reshape(
            sub.shape[:-1] + (-1,)).contiguous()
        out[f"ctx_ntt_{i}"] = sctx.ntt(loc_c, idx).numpy()
        out[f"ctx_intt_{i}"] = sctx.intt(sctx.local(sub), idx).numpy()
    pm.reset_collectives()
    sctx.ntt(loc_c, SUBSETS[-1])
    sctx.intt(sctx.local(sub), SUBSETS[-1])
    out["ctx_a2a_ops"] = np.array(pm.read_collectives()["all_to_all"]["ops"])

    # re-encryption and rotations of client data on the coef mesh
    key = lambda name: KeySwitchKey(sctx.local(_t(z[name])))
    stacks, scale = _t(z["stacks"]), float(z["scale"])
    c1 = Ciphertext(sctx.local(stacks[0]), scale)
    c2 = Ciphertext(sctx.local(stacks[1]), scale)
    out["reenc"] = ss.re_encrypt_sharded(sctx, c1, key("rk12")).data.numpy()
    rot = {k: key(f"rot{k}") for k in ROTS}
    for k in ROTS:
        out[f"rot_{k}"] = ss.rotate_sharded(sctx, c2, k, rot[k]).data.numpy()
    out["conj"] = ss.conjugate_sharded(sctx, c2, key("conj")).data.numpy()
    for k, ct in zip(ROTS, ss.rotate_hoisted_sharded(sctx, c2, ROTS, rot)):
        out[f"hoisted_{k}"] = ct.data.numpy()

    # the round on client × coef meshes
    for nc, nd in _layouts(D):
        m = pm.make_mesh({"client": nc, "coef": nd}, "cpu")
        sc = ss.ShardedEvalContext(ctx_params, m)
        loc = sc.local(pm.shard(stacks, pm.axis_index(m, "client"), nc, 0))
        lk = lambda name: KeySwitchKey(sc.local(_t(z[name])))
        pm.reset_collectives()
        avg, back = ss.fedavg_round_sharded(sc, loc, lk("rk12"), lk("rk21"), scale)
        c = pm.read_collectives()
        out[f"round_{nc}x{nd}_avg"], out[f"round_{nc}x{nd}_back"] = avg.numpy(), back.numpy()
        out[f"round_{nc}x{nd}_reduce_ops"] = np.array(c["all_reduce"]["ops"])
        out[f"round_{nc}x{nd}_a2a_ops"] = np.array(c["all_to_all"]["ops"])

    # client-axis aggregation and threshold: every rank a block of clients
    cm = pm.make_mesh({"client": D}, "cpu")
    mine = lambda name: pm.shard(_t(z[name]), r, D, 0)
    agg = mine("agg_stack")
    n_total = z["agg_stack"].shape[0]
    out["agg_avg"] = multikey.aggregate_sharded(ctx, agg, cm, scale, n_total).data.numpy()
    out["agg_sum"] = multikey.aggregate_sharded(ctx, agg, cm, scale, n_total,
                                                average=False).data.numpy()
    pk = th.joint_public_key_sharded(ctx, _t(z["crs"]), mine("b_shares"), cm)
    out["joint_pk"] = pk.data.numpy()
    parties = z["b_shares"].shape[0]
    per = parties // D
    gens = [torch.Generator().manual_seed(int(z["flood_seed"]) + i)
            for i in range(r * per, (r + 1) * per)]
    ct = Ciphertext(_t(z["th_ct"]), float(z["th_scale"]))
    out["pdec"] = th.partial_decrypt_psum(ctx, ct, mine("s_shares"), gens, cm).numpy()


def multihost_fedavg(z, out):
    """The twin of tests/test_multihost.py's worker: 2 local clients a
    process on the global client mesh, the joint threshold key recomputed
    from global seeds on every process, the aggregate and its fused
    decryption."""
    from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
    from ppqsflhe_tpu_torch.ckks.rlwe import decode_coeffs

    nprocs, pid = dist.get_world_size(), dist.get_rank()
    sch = CkksScheme(convert.params(json.loads(str(z["params"]))), device="cpu")
    mesh = multihost.global_client_mesh("cpu")
    n_total = 2 * nprocs
    a = th.common_random_poly(sch.ctx, seed=5, device="cpu")
    shares, b_shares = [], []
    for i in range(n_total):
        sk_i, b_i = th.partial_keygen(sch.ctx, a, torch.Generator().manual_seed(300 + i))
        shares.append(sk_i)
        b_shares.append(b_i)
    pk = th.joint_public_key(sch.ctx, a, b_shares)
    vecs = [np.random.default_rng(50 + i).uniform(-1, 1, sch.encoder.slots)
            for i in range(n_total)]
    local_cts = [sch.encrypt_values(pk, vecs[2 * pid + j],
                                    torch.Generator().manual_seed(60 + 2 * pid + j))
                 for j in range(2)]
    scale = local_cts[0].scale
    local_stack = torch.stack([ct.data[None] for ct in local_cts])   # (2, B=1, 2, l, N)
    agg = multihost.aggregate_multihost(sch.ctx, local_stack, mesh, scale, n_total)
    agg_one = Ciphertext(agg.data[0], agg.scale)
    s_local = torch.stack([shares[2 * pid + j].s_eval for j in range(2)])
    gens = [torch.Generator().manual_seed(70 + 2 * pid + j) for j in range(2)]
    coeffs = multihost.partial_decrypt_multihost(sch.ctx, agg_one, s_local, gens, mesh)
    got = decode_coeffs(sch.ctx, coeffs, agg_one, sch.encoder)
    out["err"] = np.array(float(np.abs(np.asarray(got) - np.mean(vecs, axis=0)).max()))
    out["agg"] = agg.data.numpy()


def mesh_d8(z, out):
    """tests/test_torch_mesh_d8.py: ShardedNtt over the QP chain and
    fedavg_round_sharded on a client 1 × coef D mesh, D the world size, and
    the collectives the round issues."""
    D, r = dist.get_world_size(), dist.get_rank()
    params = convert.params(json.loads(str(z["params"])))
    ctx = CkksContext(params)
    mesh = pm.make_mesh({"client": 1, "coef": D}, "cpu")
    n1, n2, L = ctx.fntt.n1, ctx.fntt.n2, len(ctx.moduli_qp)
    sn = ShardedNtt(params.n, ctx.moduli_qp, ctx.basis.psis, mesh)
    x, y = _t(z["x"]).reshape(-1, L, n1, n2), _t(z["y"]).reshape(-1, L, n2, n1)
    out["ntt"] = sn.ntt(pm.shard(x, r, D, -1).contiguous()).numpy()
    out["intt"] = sn.intt(pm.shard(y, r, D, -1).contiguous()).numpy()
    sctx = ss.ShardedEvalContext(params, mesh)
    key = lambda name: KeySwitchKey(sctx.local(_t(z[name])))
    pm.reset_collectives()
    avg, back = ss.fedavg_round_sharded(sctx, sctx.local(_t(z["stacks"])), key("rk12"),
                                        key("rk21"), float(z["scale"]))
    out["avg"], out["back"] = avg.numpy(), back.numpy()
    out["colls"] = np.array(json.dumps(pm.read_collectives()))


def mesh_16(z, out):
    """tests/test_torch_mesh_16.py: on a client axis of every rank,
    psum_mod of this rank's residues and the joint key with this rank's
    party; on a coef axis of every rank, this rank's shard of ShardedNtt."""
    D, r = dist.get_world_size(), dist.get_rank()
    params = convert.params(json.loads(str(z["params"])))
    ctx = CkksContext(params)
    qp = ctx.moduli_qp
    clients = pm.make_mesh({"client": D}, "cpu")
    q = torch.tensor(qp, dtype=torch.int64)[:, None]
    out["psum"] = pm.psum_mod(_t(z["terms"][r]), q, pm.axis_group(clients, "client")).numpy()
    out["joint_pk"] = th.joint_public_key_sharded(ctx, _t(z["crs"]), _t(z["b"][r:r + 1]),
                                                  clients).data.numpy()
    sn = ShardedNtt(params.n, qp, ctx.basis.psis, pm.make_mesh({"coef": D}, "cpu"))
    L, n1, n2 = len(qp), sn.n1, sn.n2
    x, y = _t(z["x"]).reshape(-1, L, n1, n2), _t(z["y"]).reshape(-1, L, n2, n1)
    out["ntt"] = sn.ntt(pm.shard(x, r, D, -1).contiguous()).numpy()
    out["intt"] = sn.intt(pm.shard(y, r, D, -1).contiguous()).numpy()


def agg_fold(z, out):
    """tests/test_torch_multikey.py's fold divergence: this rank's client of
    the stack, summed over every rank by aggregate_sharded (average off)."""
    r = dist.get_rank()
    ctx = CkksContext(convert.params(json.loads(str(z["params"]))))
    mesh = pm.make_mesh({"client": dist.get_world_size()}, "cpu")
    out["agg"] = multikey.aggregate_sharded(ctx, _t(z["stack"][r:r + 1]), mesh, 1.0,
                                            z["stack"].shape[0], average=False).data.numpy()


def mesh_graphs(z, out):
    """tests/test_torch_mesh_graphs.py: the mesh compositions through their
    graph caches with the card's stand-ins (``torch_graph_standins``), each
    called WARMUP + 2 times, so that the last result is a replay: the
    re-encryption, rotations, conjugation and hoisted rotations on a coef
    mesh of every rank, the round on client 1 × coef D, and
    ``aggregate_sharded``, the joint key and ``partial_decrypt_psum`` on a
    client axis of every rank; the caches' keys, captures and replays, the
    replays' collective tally, the static buffers of the psum after a call,
    ``all_gather_stack`` against every rank's input, and every body run
    again warm with the host syncs patched to raise."""
    import torch_graph_standins as standins

    from ppqsflhe_tpu_torch.ckks.scheme import WARMUP
    from ppqsflhe_tpu_torch.utils import graphs

    D, r = dist.get_world_size(), dist.get_rank()
    params = convert.params(json.loads(str(z["params"])))
    ctx = CkksContext(params)
    coef = pm.make_mesh({"client": 1, "coef": D}, "cpu")
    cm = pm.make_mesh({"client": D}, "cpu")

    x = torch.arange(6, dtype=torch.int64).reshape(2, 3) * (r + 1)
    pm.reset_collectives()
    got = pm.all_gather_stack(x, pm.axis_group(cm, "client"))
    out["gather_ok"] = np.array(torch.equal(got, torch.stack([x // (r + 1) * (k + 1)
                                                               for k in range(D)])))
    out["gather_bytes"] = np.array(pm.read_collectives()["all_gather"]["bytes"])

    standins.install(setattr)
    sctx = ss.ShardedEvalContext(params, coef)
    key = {name: KeySwitchKey(sctx.local(_t(z[name])))
           for name in ["rk12", "rk21", "conj"] + [f"rot{k}" for k in ROTS]}
    stacks, scale = _t(z["stacks"]), float(z["scale"])
    local, c1 = sctx.local(stacks), Ciphertext(sctx.local(stacks[0]), scale)
    c2 = Ciphertext(sctx.local(stacks[1]), scale)
    rot = {k: key[f"rot{k}"] for k in ROTS}
    mine = {name: pm.shard(_t(z[name]), r, D, 0) for name in ("agg_stack", "b_shares",
                                                               "s_shares")}
    crs = _t(z["crs"])
    per = z["b_shares"].shape[0] // D
    th_ct = Ciphertext(_t(z["th_ct"]), float(z["th_scale"]))
    gens = lambda: [torch.Generator().manual_seed(int(z["flood_seed"]) + i)
                    for i in range(r * per, (r + 1) * per)]
    n_total = z["agg_stack"].shape[0]
    calls = {
        "reenc": lambda: [ss.re_encrypt_sharded(sctx, c1, key["rk12"]).data],
        "conj": lambda: [ss.conjugate_sharded(sctx, c2, key["conj"]).data],
        "round": lambda: list(ss.fedavg_round_sharded(sctx, local, key["rk12"], key["rk21"],
                                                      scale)),
        "agg_avg": lambda: [multikey.aggregate_sharded(ctx, mine["agg_stack"], cm, scale,
                                                       n_total).data],
        "joint_pk": lambda: [th.joint_public_key_sharded(ctx, crs, mine["b_shares"], cm).data],
        "pdec": lambda: [th.partial_decrypt_psum(ctx, th_ct, mine["s_shares"], gens(), cm)],
    }
    for k in ROTS:
        calls[f"rot_{k}"] = lambda k=k: [ss.rotate_sharded(sctx, c2, k, rot[k]).data]
    calls["hoisted"] = lambda: [c.data for c in ss.rotate_hoisted_sharded(sctx, c2, ROTS, rot)]
    pm.reset_collectives()
    graphs.reset_replayed()
    for name, fn in calls.items():
        for _ in range(WARMUP + 2):
            res = fn()
        for i, t in enumerate(res):
            out[f"{name}_{i}"] = t.numpy()
    ops = dict(sctx._graphs)
    ops.update(graphs.group_cache(pm.axis_group(cm, "client")))
    out["keys"] = np.array(json.dumps(sorted(
        json.dumps([x for x in k[0] if isinstance(x, (str, int, float, list, tuple))])
        for k in ops)))
    out["captures"] = np.array(len(standins.ReplayingGraph.captures))
    out["replays"] = np.array([op.replays for op in ops.values()])
    tally = {c: {"ops": 0, "bytes": 0} for c in pm.collectives}
    for op in ops.values():
        for c, v in op.graph.collectives.items():
            for f in v:
                tally[c][f] += v[f] * op.replays
    out["tally_ok"] = np.array(tally == graphs.replayed_collectives
                               and any(v["ops"] for v in tally.values()))
    (psum,) = [op for k, op in ops.items() if k[0][0] == "partial_decrypt_psum"]
    out["psum_zero"] = np.array(all(not t.any() for t in [
        *psum.static, *graphs._tensors(psum.graph.output)]))
    out["round_colls"] = np.array(json.dumps(
        [op.graph.collectives for k, op in ops.items() if k[0][0] == "fedavg"]))

    with graphs.eager():
        warm = {name: fn() for name, fn in calls.items()}
        standins.refuse_host_syncs(setattr)
        steady = {name: fn() for name, fn in calls.items()}
    out["no_host_sync"] = np.array(all(torch.equal(a, b) for name in calls
                                       for a, b in zip(warm[name], steady[name])))


SCENARIOS = {"parallel": parallel, "multihost": multihost_fedavg, "mesh_d8": mesh_d8,
             "mesh_16": mesh_16, "agg_fold": agg_fold, "mesh_graphs": mesh_graphs}


def main():
    scenario, inputs, out_dir = sys.argv[1:4]
    if scenario == "multihost":
        multihost.initialize(f"127.0.0.1:{os.environ['MASTER_PORT']}",
                             int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]), "cpu")
    else:
        multihost.initialize(device="cpu")
    z = np.load(inputs)
    out = {}
    try:
        SCENARIOS[scenario](z, out)
        np.savez(os.path.join(out_dir, f"rank{dist.get_rank()}.npz"), **out)
    finally:
        pm.destroy_process_group()


if __name__ == "__main__":
    main()
