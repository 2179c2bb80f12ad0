"""The port's counterparts of the JAX package's last compiled sites on the
CPU, where no CUDA graph is captured and every entry point runs its eager
body: the sharded context's ``cached_graph`` (the JAX ``cached_jit``:
``re_encrypt_sharded``, ``rotate_sharded`` / ``conjugate_sharded``,
``rotate_hoisted_sharded``, ``fedavg_round_sharded``), the graph cache of
the mesh functions on a plain context (``multikey.aggregate_sharded``,
``threshold.joint_public_key_sharded`` / ``partial_decrypt_psum``) and the
threshold tools' bodies through the scheme's cache.

- ``utils.graphs.Graph`` counts the collectives a capture holds, restores
  the mesh's counter (a capture issues nothing), adds them to the replays'
  tally at each replay, ties itself to the process groups, and once
  released raises at a replay; ``mesh.destroy_process_group`` releases
  before it destroys; ``all_gather_stack`` gathers into one tensor.
- The caches' bookkeeping, with the card's stand-ins of
  ``tests/torch_graph_standins.py`` on a one-rank ``gloo`` group: the JAX
  keys plus signatures, WARMUP eager calls, one capture per key, replays;
  inputs copied in, results cloned; the psum's and the tools' static
  buffers zero after a call; a failed capture raising with the key, no
  eager fallback.
- No body makes a host sync once warm, on one rank and on a 2-rank job.
- Through the cached entry points (the last of WARMUP + 2 calls a
  replay), on a 2-rank ``gloo`` job: the compositions and
  ``aggregate_sharded`` bit-equal to the JAX functions (the references of
  ``tests/test_torch_parallel.py``), the joint key to the JAX one, the
  psum to the port's single-device fusion; and the tools' documents
  bit-equal to the JAX ``partial_decrypt`` / ``partial_decrypt_t`` fed the
  port's draws and to the JAX tool's fusion, the same bytes as the eager
  tools.

The captures on the card, with NCCL collectives inside, each replay
``torch.equal`` to its eager body, are ``chip_smoke.py``'s phase 12 (and
phase 10's run C for the tools)."""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppqsflhe_tpu.ckks import serialize as jser
from ppqsflhe_tpu.ckks import threshold as jth
from ppqsflhe_tpu.fl import api as japi
from ppqsflhe_tpu_torch.ckks import eval as ev
from ppqsflhe_tpu_torch.ckks import multikey
from ppqsflhe_tpu_torch.ckks import threshold as th
from ppqsflhe_tpu_torch.ckks.params import CkksParams
from ppqsflhe_tpu_torch.ckks.scheme import WARMUP, CkksScheme
from ppqsflhe_tpu_torch.ckks.serialize import _b64_to_arr
from ppqsflhe_tpu_torch.ckks.types import Ciphertext
from ppqsflhe_tpu_torch.fl import api
from ppqsflhe_tpu_torch.parallel import mesh as pm
from ppqsflhe_tpu_torch.parallel import multihost
from ppqsflhe_tpu_torch.parallel import sharded_scheme as ss
from ppqsflhe_tpu_torch.utils import graphs
from test_torch_compiled import HOST_SYNCS
from test_torch_parallel import FLOOD_SEED, _eval_full, _u, jref, world  # noqa: F401

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_graph_standins as standins  # noqa: E402
from torch_dist_worker import ROTS  # noqa: E402

N = 1 << 10
PARTIES = 4
WORKER_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def group():
    with pm.single_process_group("cpu"):
        yield


@pytest.fixture(scope="module")
def small(group):
    """N=2^10 four-step: a scheme, its sharded context on client 1 × coef
    1, a client mesh, keys (rekeys, rotations 1 and 2, conjugation) and
    threshold parties."""
    sch = CkksScheme(CkksParams.generate(n=N, mult_depth=2, scale_bits=40, dnum=2),
                     device="cpu")
    ctx = sch.ctx
    gen = torch.Generator().manual_seed(31)
    sk1, pk1 = sch.keygen(gen)
    sk2, pk2 = sch.keygen(gen)
    a = th.common_random_poly(ctx, 5, "cpu")
    parties = [th.partial_keygen(ctx, a, gen) for _ in range(PARTIES)]
    return dict(
        sch=sch, ctx=ctx, gen=gen, sk2=sk2, pk2=pk2, a=a,
        sctx=ss.ShardedEvalContext(sch.params, pm.make_mesh({"client": 1, "coef": 1}, "cpu")),
        cmesh=pm.make_mesh({"client": 1}, "cpu"),
        rk12=ev.ksk_to_mont(ctx, sch.rekey_gen(sk1, pk2, gen)),
        rk21=ev.ksk_to_mont(ctx, sch.rekey_gen(sk2, pk1, gen)),
        rots=sch.rotation_key_gen(sk2, [1, 2], gen), conj=sch.conjugation_key_gen(sk2, gen),
        s_parties=torch.stack([s.s_eval for s, _ in parties]),
        joint=th.joint_public_key(ctx, a, [b for _, b in parties]))


def _cts(sch, gen, lead):
    L = sch.params.num_q
    data = torch.stack([torch.randint(0, q, tuple(lead) + (2, sch.params.n), generator=gen)
                        for q in sch.ctx.moduli_qp[:L]], dim=-2)
    return Ciphertext(data, sch.params.scale)


def _compositions(w):
    """Each composition: (name, fresh inputs, the call returning tensors)."""
    sch, ctx, sctx, cmesh, gen = w["sch"], w["ctx"], w["sctx"], w["cmesh"], w["gen"]
    mq, scale = ctx.moduli_qp, sch.params.scale
    return (
        ("reenc", lambda: (_cts(sch, gen, (3,)),),
         lambda c: [ss.re_encrypt_sharded(sctx, c, w["rk12"]).data]),
        ("rotate", lambda: (_cts(sch, gen, (3,)),),
         lambda c: [ss.rotate_sharded(sctx, c, 1, w["rots"][1]).data]),
        ("conjugate", lambda: (_cts(sch, gen, (3,)),),
         lambda c: [ss.conjugate_sharded(sctx, c, w["conj"]).data]),
        ("hoisted", lambda: (_cts(sch, gen, (3,)),),
         lambda c: [o.data for o in ss.rotate_hoisted_sharded(sctx, c, [1, 2], w["rots"])]),
        ("fedavg", lambda: (_cts(sch, gen, (2, 3)).data,),
         lambda st: list(ss.fedavg_round_sharded(sctx, st, w["rk12"], w["rk21"], scale))),
        ("aggregate_sharded", lambda: (_cts(sch, gen, (3, 2)).data,),
         lambda st: [multikey.aggregate_sharded(ctx, st, cmesh, scale, 3).data]),
        ("joint_public_key_sharded",
         lambda: (torch.stack([torch.randint(0, q, (PARTIES, N), generator=gen) for q in mq],
                              dim=1),),
         lambda b: [th.joint_public_key_sharded(ctx, w["a"], b, cmesh).data]),
        ("partial_decrypt_psum",
         lambda: (_cts(sch, gen, (3,)), int(torch.randint(1 << 30, (), generator=gen))),
         lambda c, seed: [th.partial_decrypt_psum(
             ctx, c, w["s_parties"], [torch.Generator().manual_seed(seed + i)
                                      for i in range(PARTIES)], cmesh)]),
    )


def _entries(w):
    """The caches' entries: the sharded context's, then the client group's."""
    ops = dict(w["sctx"]._graphs)
    ops.update(graphs.group_cache(pm.axis_group(w["cmesh"], "client")))
    return ops


@pytest.fixture
def card(monkeypatch, small):
    """The card's stand-ins installed, and the caches emptied before and
    after."""
    pm.release_graphs()
    standins.install(monkeypatch.setattr)
    graphs.reset_replayed()
    yield standins
    pm.release_graphs()


# ---------------------------------------------------------------------------
# Graph: collectives counted, tallied and tied to the groups
# ---------------------------------------------------------------------------

def test_graph_counts_collectives_and_ties_to_the_groups(group, monkeypatch):
    """A capture holding a psum, a tiled all-to-all and an all-gather: the
    mesh's counter is restored, the graph keeps the three, each replay adds
    them to the tally, the graph is tied to the groups, and once released
    (before the groups are destroyed) a replay raises."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", standins.FakeCUDAGraph)
    monkeypatch.setattr(torch.cuda, "graph", standins.fake_capture)
    g = pm.axis_group(pm.make_mesh({"client": 1}, "cpu"), "client")
    x = torch.arange(48, dtype=torch.int64).reshape(2, 4, 6)
    q = torch.full((4, 1), 97, dtype=torch.int64)

    def fn():
        return (pm.psum_mod(x % 97, q, g), pm.all_to_all_tiled(x, g, 1, 2),
                pm.all_gather_stack(x, g))

    pm.reset_collectives()
    graphs.reset_replayed()
    graph = graphs.Graph(fn, "three collectives")
    assert all(c["ops"] == 0 for c in pm.collectives.values())
    want = {"all_to_all": {"ops": 1, "bytes": 384}, "all_reduce": {"ops": 1, "bytes": 384},
            "all_gather": {"ops": 1, "bytes": 384}}
    assert graph.collectives == want
    assert all(v == 0 for v in graph.launches.values())
    assert graph in pm._tied.values()
    graph.replay()
    graph.replay()
    assert graphs.replayed_collectives == {k: {f: 2 * v for f, v in c.items()}
                                           for k, c in want.items()}
    assert all(c["ops"] == 0 for c in pm.collectives.values())
    graphs.reset_replayed()
    assert all(c == {"ops": 0, "bytes": 0} for c in graphs.replayed_collectives.values())
    pm.release_graphs()
    with pytest.raises(RuntimeError, match="three collectives: its graph was released"):
        graph.replay()
    # a graph without collectives is not tied
    quiet = graphs.Graph(lambda: x + 1, "no collective")
    assert quiet not in pm._tied.values()


def test_destroy_releases_before_destroying(monkeypatch):
    """``mesh.destroy_process_group`` (and so ``single_process_group``'s
    exit) releases every tied graph first."""
    order = []

    class Tied:
        def release(self):
            order.append("release")

    obj = Tied()
    pm.tie(obj)
    monkeypatch.setattr(pm.dist, "destroy_process_group", lambda: order.append("destroy"))
    pm.destroy_process_group()
    assert order == ["release", "destroy"]


def test_all_gather_stack_into_one_tensor(group, monkeypatch):
    """One ``all_gather_into_tensor`` into a preallocated (D, ...) tensor,
    never the list form; rank order and counted bytes as before."""
    monkeypatch.setattr(pm.dist, "all_gather", standins.refuse("all_gather"))
    g = pm.axis_group(pm.make_mesh({"client": 1}, "cpu"), "client")
    x = torch.arange(12, dtype=torch.int64).reshape(3, 4)[:, ::2]       # not contiguous
    pm.reset_collectives()
    got = pm.all_gather_stack(x, g)
    assert got.shape == (1, 3, 2) and torch.equal(got[0], x)
    assert pm.read_collectives()["all_gather"] == {"ops": 1, "bytes": 48}


def test_local_width(small):
    """The compiled round's static stacks are ``ctx.local_n`` wide: N on a
    plain context, N/D on a sharded one."""
    assert small["ctx"].local_n == N and small["sctx"].local_n == N // small["sctx"].D


# ---------------------------------------------------------------------------
# The caches' bookkeeping
# ---------------------------------------------------------------------------

def test_cache_keys_are_the_jax_keys(small, card):
    """One entry per JAX ``cached_jit`` key (rotation and conjugation share
    ``("galois", g, l)``, two Galois elements), plus the mesh functions'
    (function, context, …) keys, each followed by the inputs' signatures."""
    w = small
    for _, make, fn in _compositions(w):
        fn(*make())
    L, n1 = w["sch"].params.num_q, w["sctx"].n1
    gs = tuple(ev.rot_to_galois(r, N) for r in (1, 2))
    keys = {k[0] for k in w["sctx"]._graphs}
    assert keys == {("reenc", L), ("galois", gs[0], L), ("galois", 2 * N - 1, L),
                    ("hoisted", gs, L), ("fedavg", "client", 2, 3, L, w["sch"].params.scale)}
    assert n1 * w["sctx"].n2 == N
    group_keys = {k[0] for k in graphs.group_cache(pm.axis_group(w["cmesh"], "client"))}
    assert group_keys == {("aggregate_sharded", w["ctx"], w["sch"].params.scale, 3, True),
                          ("joint_public_key_sharded", w["ctx"]),
                          ("partial_decrypt_psum", w["ctx"])}
    (reenc,) = [k for k in w["sctx"]._graphs if k[0][0] == "reenc"]
    assert reenc[1] == ("Ciphertext", (3, 2, L, N), torch.int64, "cpu", w["sch"].params.scale)
    assert reenc[2] == ("KeySwitchKey", tuple(w["rk12"].data.shape), torch.int64, "cpu", True)


def test_warmup_capture_replay_clones_and_tally(small, card):
    """Each composition: WARMUP eager warm-ups, then one capture, then
    replays; each result equals the eager body on its inputs and stays so
    after later calls (a clone); the static inputs are copies; the replays'
    collectives are tallied, the mesh's counter counts only eager calls."""
    w = small
    calls = WARMUP + 3
    for name, make, fn in _compositions(w):
        before = set(_entries(w))
        captures = len(card.ReplayingGraph.captures)
        kept = []
        for i in range(calls):
            inputs = make()
            got = fn(*inputs)
            with graphs.eager():
                want = fn(*inputs)
            kept.append((got, want))
            assert len(card.ReplayingGraph.captures) == captures + (i >= WARMUP), name
        for got, want in kept:
            assert all(torch.equal(a, b) for a, b in zip(got, want)), name
        assert not all(torch.equal(a, b) for a, b in zip(kept[-1][0], kept[-2][0])), name
        (new,) = set(_entries(w)) - before
        op = _entries(w)[new]
        assert op.graph is not None and op.replays == calls - WARMUP and op.calls == WARMUP
        outs = {t.data_ptr() for t in graphs._tensors(op.graph.output)}
        assert not outs & {t.data_ptr() for t in kept[-1][0]}, name
        ins = [t.data_ptr() for x in inputs if not isinstance(x, int)
               for t in graphs._tensors(x)]
        assert not set(ins) & {t.data_ptr() for t in op.static}, name
    tally = {c: {"ops": 0, "bytes": 0} for c in pm.collectives}
    for op in _entries(w).values():
        for c, v in op.graph.collectives.items():
            for f in v:
                tally[c][f] += v[f] * op.replays
    assert graphs.replayed_collectives == tally
    assert tally["all_to_all"]["ops"] and tally["all_reduce"]["ops"] and tally["all_gather"]["ops"]
    (fedavg,) = [op for k, op in _entries(w).items() if k[0][0] == "fedavg"]
    assert fedavg.graph.collectives["all_to_all"]["ops"] == 11
    assert fedavg.graph.collectives["all_reduce"]["ops"] == 1


def test_psum_scrubs_its_static_buffers(small, card):
    """``partial_decrypt_psum`` zeroes its shares, floods and plaintext in
    the cache after every call; ``aggregate_sharded`` (public) does not."""
    w = small
    comps = {name: (make, fn) for name, make, fn in _compositions(w)}
    for name in ("partial_decrypt_psum", "aggregate_sharded"):
        make, fn = comps[name]
        for _ in range(WARMUP + 2):
            fn(*make())
    ops = {k[0][0]: op for k, op in _entries(w).items()}
    bufs = lambda op: [*op.static, *graphs._tensors(op.graph.output)]
    assert all(not t.any() for t in bufs(ops["partial_decrypt_psum"]))
    assert any(t.any() for t in bufs(ops["aggregate_sharded"]))


def test_released_entries_raise(small, card):
    """Released before the groups are destroyed: the cache is empty, a
    kept entry and its graph raise instead of replaying."""
    w = small
    make, fn = _compositions(w)[4][1:]
    for _ in range(WARMUP + 1):
        fn(*make())
    (op,) = w["sctx"]._graphs.values()
    graph = op.graph
    pm.release_graphs()
    assert not w["sctx"]._graphs and op.released and op.graph is None
    with pytest.raises(RuntimeError, match="released"):
        op((make()[0], w["rk12"], w["rk21"]))
    with pytest.raises(RuntimeError, match="released"):
        graph.replay()


@pytest.mark.parametrize("which", ["sharded", "group"])
def test_failed_capture_raises_naming_the_key(small, monkeypatch, which):
    """With the real capture on a CPU build, the call that captures raises
    ``RuntimeError`` naming the composition and its key; no eager
    fallback."""
    w = small
    pm.release_graphs()
    monkeypatch.setattr(graphs, "on_card", lambda x: True)
    monkeypatch.setattr(graphs, "warm_up", standins.eager_warm_up)
    name, make, fn = _compositions(w)[0 if which == "sharded" else 5]
    for _ in range(WARMUP):
        fn(*make())
    pattern = (r"capture of the sharded composition \(\('reenc', 3\)" if which == "sharded"
               else r"capture of the mesh function \(\('aggregate_sharded'")
    with pytest.raises(RuntimeError, match=pattern):
        fn(*make())
    pm.release_graphs()


# ---------------------------------------------------------------------------
# No host sync in a warm body
# ---------------------------------------------------------------------------

def _tool_bodies(w):
    """The three threshold tools' bodies on drawn floods (the tools draw
    them before the cache)."""
    sch, ctx, gen = w["sch"], w["ctx"], w["gen"]
    ct = _cts(sch, gen, (3,))
    flood = th.flood(ctx, ct, gen, 30, "cpu")
    s, sigma = w["s_parties"][0], w["s_parties"][1]
    parts = torch.stack([th.decryption_share(ctx, ct, w["s_parties"][i], flood)
                         for i in range(2)])
    return {
        "threshold_partial_decrypt": lambda: [th.decryption_share(ctx, ct, s, flood)],
        "threshold_partial_decrypt_t": lambda: [th.decryption_share(
            ctx, ct, th.scaled_sigma(ctx, sigma, (1, 3), 3, ct.nlimbs), flood)],
        "threshold_fuse_decrypt": lambda: [th.fuse_partial_decryptions(ctx, ct, list(parts))],
    }


def test_no_host_sync_once_warm(small, monkeypatch):
    """Every composition's and tool's body, warm, runs with every host sync
    patched to raise and gives the warm call's residues (the floods drawn
    before)."""
    assert standins.HOST_SYNCS == HOST_SYNCS
    w = small
    calls = {name: (lambda fn=fn, inputs=make(): fn(*inputs))
             for name, make, fn in _compositions(w)}
    calls.update(_tool_bodies(w))
    with graphs.eager():
        warm = {k: f() for k, f in calls.items()}
        warm = {k: f() for k, f in calls.items()}
        standins.refuse_host_syncs(monkeypatch.setattr)
        steady = {k: f() for k, f in calls.items()}
    monkeypatch.undo()
    for k in calls:
        assert all(torch.equal(a, b) for a, b in zip(warm[k], steady[k])), k


# ---------------------------------------------------------------------------
# A 2-rank gloo job through the cached entry points, against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks2(world, tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_graphs")
    multihost.spawn_ranks(["tests/torch_dist_worker.py", "mesh_graphs", str(world["path"]),
                           str(out)], 2, "cpu", timeout=WORKER_TIMEOUT_S)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


def test_two_ranks_cached_equal_jax(ranks2, world, jref):
    """The last of WARMUP + 2 calls (a replay) of each composition on 2
    ranks equals the JAX function: re-encryption, rotations, conjugation,
    hoisted rotations, the round (client 1 × coef 2), aggregate_sharded and
    the joint key; the psum equals the port's single-device fusion."""
    res = ranks2
    full = lambda name: _u(_eval_full([r[name] for r in res], world))
    np.testing.assert_array_equal(full("reenc_0"), jref["reenc"])
    np.testing.assert_array_equal(full("conj_0"), jref["conj"])
    for i, k in enumerate(ROTS):
        np.testing.assert_array_equal(full(f"rot_{k}_0"), jref[f"rot_{k}"])
        np.testing.assert_array_equal(full(f"hoisted_{i}"), jref[f"hoisted_{k}"])
    np.testing.assert_array_equal(full("round_0"), jref["avg"])
    np.testing.assert_array_equal(full("round_1"), jref["back"])
    ctx, ct = world["sch"].ctx, world["th_cipher"]
    partials = [th.partial_decrypt(ctx, s, ct, torch.Generator().manual_seed(FLOOD_SEED + i))
                for i, (s, _) in enumerate(world["parties"])]
    pdec = th.fuse_partial_decryptions(ctx, ct, partials).numpy()
    for r in res:
        np.testing.assert_array_equal(_u(r["agg_avg_0"]), jref["agg_avg"])
        np.testing.assert_array_equal(_u(r["joint_pk_0"]), jref["joint_pk"])
        np.testing.assert_array_equal(r["pdec_0"], pdec)


def test_two_ranks_bookkeeping(ranks2):
    """On each rank: the JAX keys, one capture per key, two replays each,
    the replays' collectives tallied, the round's graph holding 11
    all-to-alls and one all-reduce, the psum's buffers zero after a call,
    the all-gather in rank order, and no host sync in a warm body."""
    names = ["aggregate_sharded", "fedavg", "galois", "hoisted", "joint_public_key_sharded",
             "partial_decrypt_psum", "reenc"]
    for r in ranks2:
        keys = [json.loads(k) for k in json.loads(str(r["keys"]))]
        assert sorted({k[0] for k in keys}) == names
        assert len(keys) == 9                   # galois: rotations 1, -3 and conjugation
        assert int(r["captures"]) == 9 and list(r["replays"]) == [2] * 9
        assert bool(r["tally_ok"]) and bool(r["psum_zero"]) and bool(r["no_host_sync"])
        (colls,) = json.loads(str(r["round_colls"]))
        assert colls["all_to_all"]["ops"] == 11 and colls["all_reduce"]["ops"] == 1
        assert bool(r["gather_ok"]) and int(r["gather_bytes"]) == 2 * 6 * 8


# ---------------------------------------------------------------------------
# The threshold tools through the scheme's cache, against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tools(tmp_path_factory):
    """Ring 128 (radix-2): three parties' shares from the port's tool, the
    joint key, weights encrypted under it by the JAX tool, and party 3's
    2-of-3 σ (the port's Shamir tools)."""
    d = tmp_path_factory.mktemp("tools")
    p = lambda name: str(d / name)
    japi.gen_cc({"multiplicative_depth": 2, "scaling_mod_size": 40, "batch_size": 32,
                 "PREMode": "INDCPA", "ring_dim": 128}, p("cc"))
    for i in (1, 2, 3):
        api.threshold_keygen(p("cc"), 9, p(f"sh{i}"), p(f"b{i}"), seed=60 + i, device="cpu")
    api.threshold_combine_pubkey(p("cc"), 9, [p(f"b{i}") for i in (1, 2, 3)], p("jpk"),
                                 device="cpu")
    rng = np.random.default_rng(4)
    summary = [{"layer": "w", "shape": [40], "mean": 0.0, "std_dev": 0.0,
                "values": [float(v) for v in rng.uniform(-1, 1, 40)]}]
    with open(p("w"), "w") as f:
        json.dump({"weights_summary": summary}, f)
    japi.encrypt_weights(p("cc"), p("jpk"), p("w"), p("enc"), seed=8)
    outs = {i: [p(f"f{i}to{j}") for j in (1, 2, 3)] for i in (1, 2, 3)}
    for i in (1, 2, 3):
        api.threshold_shamir_share(p("cc"), p(f"sh{i}"), 3, 2, outs[i], seed=70 + i,
                                   device="cpu")
    api.threshold_aggregate_shares(p("cc"), [outs[i][2] for i in (1, 2, 3)], p("sig3"),
                                   device="cpu")
    return p


def _doc_residues(path, l, n):
    """A partial-decryptions document's residues, one (l, n) array per
    ciphertext field in order."""
    with open(path) as f:
        doc = json.load(f)
    out = []
    for e in doc["weights_summary"]:
        out += [_b64_to_arr(s, (l, n)) for s in [e["mean"], e["std_dev"], *e["values"]]]
    return out


def test_tools_through_the_cache_equal_jax(tools, monkeypatch):
    """WARMUP + 2 calls of each threshold tool with the card's stand-ins
    (the last two replays): every partial decryption equals the JAX
    ``partial_decrypt`` / ``partial_decrypt_t`` of each ciphertext fed the
    port's flood for that seed, and is the eager tool's bytes; every fusion
    is the JAX tool's document; each tool's entry keeps its static buffers
    zero between calls."""
    p = tools
    api._scheme_for.cache_clear()
    eager = {}
    for tag, call in (("pd", lambda out, s: api.threshold_partial_decrypt(
            p("cc"), p("sh2"), p("enc"), out, seed=s, device="cpu")),
                      ("pt", lambda out, s: api.threshold_partial_decrypt_t(
            p("cc"), p("sig3"), p("enc"), out, [1, 3], 3, seed=s, device="cpu"))):
        for s in range(WARMUP + 2):
            call(p(f"{tag}_eager{s}"), 100 + s)
            eager[tag, s] = open(p(f"{tag}_eager{s}"), "rb").read()
    api._scheme_for.cache_clear()
    standins.install(monkeypatch.setattr)
    jsch = japi.load_scheme(p("cc"))
    _, jcts = japi._load_all_cts(jser.load_enc_doc(p("enc")), jsch)
    jsk = jser.deserialize_secret_key(jser.load_json(p("sh2")), jsch.ctx)
    jsigma_doc = jser.load_json(p("sig3"))
    jsigma = jnp.asarray(jser._b64_to_arr(jsigma_doc["data"], jsigma_doc["shape"]))
    l, n = jcts[0].data.shape[1], jcts[0].data.shape[2]
    sch = api.load_scheme(p("cc"), "cpu")
    cts = api._doc_batch(sch, p("enc"))[1]
    for s in range(WARMUP + 2):
        api.threshold_partial_decrypt(p("cc"), p("sh2"), p("enc"), p(f"pd{s}"), seed=100 + s,
                                      device="cpu")
        api.threshold_partial_decrypt_t(p("cc"), p("sig3"), p("enc"), p(f"pt{s}"), [1, 3], 3,
                                        seed=100 + s, device="cpu")
        assert open(p(f"pd{s}"), "rb").read() == eager["pd", s]
        assert open(p(f"pt{s}"), "rb").read() == eager["pt", s]
        flood = th.flood(sch.ctx, cts, api._rng(100 + s), th.DEFAULT_SMUDGING_BITS).numpy()
        rows = iter(list(flood))
        monkeypatch.setattr(jth, "smudging_noise",
                            lambda key, n_, bits: jnp.asarray(next(rows)))
        want = [np.asarray(jth.partial_decrypt(jsch.ctx, jsk, c, None)) for c in jcts]
        rows = iter(list(flood))
        want_t = [np.asarray(jth.partial_decrypt_t(jsch.ctx, jsigma, c, (1, 3), 3, None))
                  for c in jcts]
        for got, x in zip(_doc_residues(p(f"pd{s}"), l, n), want):
            np.testing.assert_array_equal(got, x)
        for got, x in zip(_doc_residues(p(f"pt{s}"), l, n), want_t):
            np.testing.assert_array_equal(got, x)
    for i in (1, 3):
        api.threshold_partial_decrypt(p("cc"), p(f"sh{i}"), p("enc"), p(f"pdx{i}"), seed=i,
                                      device="cpu")
    parts = [p("pdx1"), p("pd0"), p("pdx3")]
    japi.threshold_fuse_decrypt(p("cc"), p("enc"), parts, p("dec_jax"))
    for s in range(WARMUP + 2):
        api.threshold_fuse_decrypt(p("cc"), p("enc"), parts, p(f"dec{s}"), device="cpu")
        assert open(p(f"dec{s}"), "rb").read() == open(p("dec_jax"), "rb").read()
    names = {"threshold_partial_decrypt", "threshold_partial_decrypt_t",
             "threshold_fuse_decrypt"}
    ops = {k[0] if isinstance(k[0], str) else k[0][0]: (k, op) for k, op in sch._graphs.items()
           if (k[0] if isinstance(k[0], str) else k[0][0]) in names}
    assert set(ops) == names
    assert ops["threshold_partial_decrypt_t"][0][0] == ("threshold_partial_decrypt_t", (1, 3), 3)
    for k, op in ops.values():
        assert op.graph is not None and op.replays >= 2 and op.scrub, k
        assert all(not t.any() for t in [*op.static, *graphs._tensors(op.graph.output)]), k
    api._scheme_for.cache_clear()
