"""The counterparts of the JAX package's last ``jax.jit`` sites, all on the
file tools' path, on the CPU, where no CUDA graph is captured: the radix-2
transforms (``core/ntt.Radix2Ntt``'s cache, ``("ntt" | "intt", sel)``),
the seed expansion and the tools' encoding NTT (the context's cache,
``("expand_a", l)``, ``("api_ntt", l)``), sk-encryption, the batched
decryption and the aggregation's sum and ÷N (the scheme's cache,
``("encrypt_sk", l)``, ``("decrypt_batch", l, k)``, ``("aggregate", N,
lmin, free ÷N)``).

With the card's stand-ins of ``tests/torch_graph_standins.py``, at the
rings of ``tests/test_torch_fl_tools.py`` (128 radix-2, 256 four-step) and
in both containers, WARMUP + 2 runs of the tools (encryptModelWeights with
a secret and a public key, changeCipherDomain, aggregateEncryptedWeights,
decryptModelWeights, keyGen) through the graphs:

- write the bytes each tool writes inside ``graphs.eager()``, where no
  cache fills, and the JAX tools' bytes where the port's eager tools
  already match them (changeCipherDomain, aggregation, decryption);
- leave each cache holding the JAX keys, each key captured and replayed,
  and the scrubbed entries' static buffers zero.

Without the stand-ins no cache fills on the CPU; no body makes a host sync
once warm; and the cached sk-encryption on numpy-seeded draws is the JAX
tools' body on the same draws, residue for residue.

On the card, ``chip_smoke.py``'s phase 6 runs the tools through the graphs
and inside ``graphs.eager()`` in turns and holds every file byte-equal."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppqsflhe_tpu.ckks import rlwe as jrlwe
from ppqsflhe_tpu.ckks import serialize as jser
from ppqsflhe_tpu.ckks.types import Plaintext as JaxPt
from ppqsflhe_tpu.fl import api as japi
from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.ckks import rlwe
from ppqsflhe_tpu_torch.ckks import serialize as ser
from ppqsflhe_tpu_torch.ckks.scheme import WARMUP
from ppqsflhe_tpu_torch.ckks.types import Ciphertext
from ppqsflhe_tpu_torch.fl import api
from ppqsflhe_tpu_torch.utils import graphs
from test_torch_fl_tools import make_weights, read
from test_torch_random_ops import Draws

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_graph_standins as standins  # noqa: E402

CPU = dict(device="cpu")
CONTAINERS = ("json", "bin")
RUNS = WARMUP + 2           # through the graphs: WARMUP eager calls, a capture, replays
# the files one run of the tools writes, and those the JAX tools wrote too
OUTS = ("pk", "sk", "e1", "e2", "c12", "agg", "d2", "d2s")
JAX_OUTS = ("c12", "agg", "d2")
SCRUBBED = {"ntt", "intt", "api_ntt", "encrypt_sk", "decrypt_batch"}


@pytest.fixture(scope="module", params=[("radix2", 128, "xla"), ("fourstep", 256, "mxu")],
                ids=["radix2", "fourstep"])
def files(request, tmp_path_factory):
    """The JAX tools' CC, keys and documents for one context, in both
    containers; their changeCipherDomain of client 1's document, the
    aggregate of it and client 2's seeded document (lazy in JSON, not lazy
    in PQWD) and the decryption of that aggregate."""
    backend, n, impl = request.param
    d = tmp_path_factory.mktemp(backend)
    p = {k: str(d / k) for k in ("cc", "pk1", "sk1", "pk2", "sk2", "rk12", "w1", "w2")}
    p["backend"], p["dir"] = backend, str(d)
    japi.gen_cc({"multiplicative_depth": 2, "scaling_mod_size": 40, "batch_size": 32,
                 "PREMode": "INDCPA", "ring_dim": n, "ntt_backend": backend,
                 "ntt_impl": impl}, p["cc"])
    for i in (1, 2):
        japi.key_gen(p["cc"], p[f"pk{i}"], p[f"sk{i}"], seed=100 + i)
    japi.rekey_gen(p["cc"], p["sk1"], p["pk2"], p["rk12"], seed=7)
    make_weights(p["w1"], 1, with_optimizer=True)
    make_weights(p["w2"], 2)
    for c in CONTAINERS:
        j = {k: str(d / f"jax_{k}.{c}") for k in ("e1", "e2") + JAX_OUTS}
        japi.encrypt_weights(p["cc"], p["pk1"], p["w1"], j["e1"], seed=11, container=c)
        japi.encrypt_weights(p["cc"], p["sk2"], p["w2"], j["e2"], seed=12, container=c)
        japi.change_cipher_domain(p["cc"], p["rk12"], j["e1"], j["c12"])
        japi.aggregate_encrypted_weights(p["cc"], [j["c12"], j["e2"]], j["agg"],
                                         lazy=c == "json")
        japi.decrypt_weights(p["cc"], p["sk2"], j["agg"], j["d2"])
        p[c] = j
    return p


def run_tools(p, container, tag):
    """One run of the port's tools on the JAX tools' keys and documents,
    every output named after ``tag``; returns the outputs' paths."""
    j = p[container]
    o = {k: os.path.join(p["dir"], f"{tag}_{k}.{container}") for k in OUTS}
    cc = p["cc"]
    api.key_gen(cc, o["pk"], o["sk"], seed=31, **CPU)
    api.encrypt_weights(cc, p["sk2"], p["w2"], o["e2"], seed=12, container=container, **CPU)
    api.encrypt_weights(cc, p["pk1"], p["w1"], o["e1"], seed=11, container=container, **CPU)
    api.change_cipher_domain(cc, p["rk12"], j["e1"], o["c12"], **CPU)
    api.aggregate_encrypted_weights(cc, [o["c12"], j["e2"]], o["agg"], lazy=container == "json",
                                    **CPU)
    api.decrypt_weights(cc, p["sk2"], o["agg"], o["d2"], **CPU)
    api.decrypt_weights(cc, p["sk2"], o["e2"], o["d2s"], **CPU)
    return o


def caches(sch):
    """Every cache the tools fill: the radix-2 transforms' (radix-2 only),
    the context's and the scheme's."""
    out = [sch.ctx._graphs, sch._graphs]
    if sch.ctx.radix2:
        out.append(sch.ctx.fntt._graphs)
    return out


def kind(key) -> str:
    """The JAX function of a cache entry: its key's name."""
    jkey = key[0]
    return jkey if isinstance(jkey, str) else jkey[0]


@pytest.fixture(scope="module", params=CONTAINERS)
def runs(request, files):
    """With the stand-ins: one run inside ``graphs.eager()`` (the caches
    stay empty), then RUNS runs through the graphs; returns the outputs,
    the scheme and whether the eager run filled a cache."""
    container = request.param
    api._scheme_for.cache_clear()
    sch = api.load_scheme(files["cc"], "cpu")
    with pytest.MonkeyPatch.context() as mp:
        standins.install(mp.setattr)
        with graphs.eager():
            eager = run_tools(files, container, "eager")
        filled_eagerly = any(len(c) for c in caches(sch))
        through = [run_tools(files, container, f"graph{i}") for i in range(RUNS)]
        # every inverse transform of the tools runs inside another graph
        # (decrypt_batch, re_encrypt): call one directly too
        idx = sch.ctx.q_idx(sch.params.num_q)
        x = torch.arange(len(idx) * sch.params.n).reshape(len(idx), -1)
        inverse = [sch.ctx.intt(x, idx) for _ in range(RUNS)]
        captures = list(standins.ReplayingGraph.captures)
    with graphs.eager():
        assert all(torch.equal(y, sch.ctx.intt(x, idx)) for y in inverse)
    assert api.load_scheme(files["cc"], "cpu") is sch
    api._scheme_for.cache_clear()
    return dict(eager=eager, through=through, sch=sch, filled_eagerly=filled_eagerly,
                captures=captures, container=container, files=files)


def test_graphs_write_the_eager_bytes(runs):
    """Every file of every run through the graphs is the eager run's, byte
    for byte; inside ``graphs.eager()`` no cache filled."""
    assert not runs["filled_eagerly"]
    for i, o in enumerate(runs["through"]):
        for k in OUTS:
            assert read(o[k]) == read(runs["eager"][k]), (i, k)


def test_graphs_write_the_jax_bytes(runs):
    """changeCipherDomain, aggregation and decryption through the graphs
    write the JAX tools' files on the same inputs, in every run."""
    j = runs["files"][runs["container"]]
    for o in runs["through"]:
        for k in JAX_OUTS:
            assert read(o[k]) == read(j[k]), k


def test_caches_hold_the_jax_keys(runs):
    """After the runs: the radix-2 transforms under ("ntt" | "intt", sel),
    the context's ("expand_a", l) and ("api_ntt", L), the scheme's
    ("encrypt_sk", L), ("decrypt_batch", l, 2) and ("aggregate", 2, L,
    free ÷N); each kind replayed, and one capture per captured key."""
    sch = runs["sch"]
    L, K = sch.params.num_q, sch.params.num_p
    lazy = runs["container"] == "json"
    ctx_keys = {k[0] for k in sch.ctx._graphs}
    assert ctx_keys == {("expand_a", L), ("expand_a", L + K), ("api_ntt", L)}
    tool_keys = {k[0] for k in sch._graphs if kind(k) in ("encrypt_sk", "decrypt_batch",
                                                          "aggregate")}
    # either division leaves the average one limb down
    assert tool_keys == {("encrypt_sk", L), ("decrypt_batch", L - 1, 2),
                         ("decrypt_batch", L, 2), ("aggregate", 2, L, lazy)}
    if sch.ctx.radix2:
        sels = {k[0] for k in sch.ctx.fntt._graphs}
        assert {s[0] for s in sels} == {"ntt", "intt"}
        assert ("ntt", tuple(range(L + K))) in sels and ("intt", tuple(range(L))) in sels
    else:
        assert not hasattr(sch.ctx.fntt, "_graphs")
    entries = [(k, op) for c in caches(sch) for k, op in c.items()]
    for name in {kind(k) for k, _ in entries}:
        ops = [op for k, op in entries if kind(k) == name]
        assert any(op.graph is not None and op.replays for op in ops), name
    captured = [op for _, op in entries if op.graph is not None]
    assert all(op.calls == WARMUP for op in captured)
    assert sorted(op.graph.what for op in captured) == sorted(runs["captures"])


def test_scrubbed_entries_hold_zeros(runs):
    """Every captured transform, encoding transform, sk-encryption and
    batched decryption keeps zeros in its static inputs and outputs after a
    call; the seed expansion and the aggregation (public data) keep
    theirs."""
    seen = set()
    for c in caches(runs["sch"]):
        for key, op in c.items():
            if op.graph is None or kind(key) not in SCRUBBED | {"expand_a", "aggregate"}:
                continue
            held = [*op.static, *graphs._tensors(op.graph.output)]
            assert op.scrub == (kind(key) in SCRUBBED), key
            assert any(bool(t.any()) for t in held) != op.scrub, key
            seen.add(kind(key))
    want = SCRUBBED | {"expand_a", "aggregate"}
    assert seen == (want if runs["sch"].ctx.radix2 else want - {"ntt", "intt"})


def test_no_cache_fills_without_the_card(files):
    """On the CPU, without the stand-ins, every tool runs its eager bodies:
    no cache holds an entry."""
    api._scheme_for.cache_clear()
    sch = api.load_scheme(files["cc"], "cpu")
    for c in CONTAINERS:
        run_tools(files, c, "cpu")
    assert not any(len(c) for c in caches(sch))
    api._scheme_for.cache_clear()


def _bodies(sch, files):
    """Each new cached body on inputs made beforehand."""
    ctx, L = sch.ctx, sch.params.num_q
    gen = torch.Generator().manual_seed(3)
    sk = ser.deserialize_secret_key(ser.load_json(files["sk2"]), ctx, "cpu")
    rng = np.random.default_rng(3)
    pt = sch.make_plaintext([rng.uniform(-1, 1, sch.encoder.slots) for _ in range(3)])
    coeff = torch.stack([torch.randint(0, q, (3, sch.params.n), generator=gen)
                         for q in ctx.moduli_qp[:L]], dim=1)
    a, e = rlwe.encrypt_sk_draws(ctx, gen, pt, [bytes([i]) * 16 for i in range(3)])
    ct = rlwe.encrypt_sk_body(ctx, sk.s_eval, pt, a, e)
    ct2 = Ciphertext(ct.data.flip(0), ct.scale)
    idx = ctx.q_idx(L)
    return {
        "ntt": lambda: ctx.ntt(coeff, idx),
        "intt": lambda: ctx.intt(coeff, idx),
        "encrypt_sk": lambda: rlwe.encrypt_sk_body(ctx, sk.s_eval, pt, a, e).data,
        "decrypt_batch": lambda: rlwe.decrypt_to_coeffs(ctx, sk.s_eval, ct),
        "aggregate lazy": lambda: api.aggregate_batch(sch, [ct, ct2], True).data,
        "aggregate": lambda: api.aggregate_batch(sch, [ct, ct2], False).data,
    }


def test_no_host_sync_once_warm(files, monkeypatch):
    """Every new body, warm, runs with every host sync patched to raise
    and gives the warm call's residues."""
    sch = api.load_scheme(files["cc"], "cpu")
    calls = _bodies(sch, files)
    warm = {k: f() for k, f in calls.items()}
    standins.refuse_host_syncs(monkeypatch.setattr)
    steady = {k: f() for k, f in calls.items()}
    monkeypatch.undo()
    for k in calls:
        assert torch.equal(warm[k], steady[k]), k


def test_cached_encrypt_sk_equals_jax_on_the_same_draws(files, monkeypatch):
    """WARMUP + 2 calls of ``CkksScheme.encrypt_sk`` through the cache (the
    stand-ins; the last two replays) on numpy-seeded Gaussian draws: each
    batch equals the JAX tools' body (``_encrypt_sk_with_a``) fed the same
    draws and the JAX expansion of the same seeds, entry by entry; one
    sampler call a batch."""
    api._scheme_for.cache_clear()
    sch = api.load_scheme(files["cc"], "cpu")
    jsch = japi.load_scheme(files["cc"])
    sk = ser.deserialize_secret_key(ser.load_json(files["sk2"]), sch.ctx, "cpu")
    jsk = jser.deserialize_secret_key(jser.load_json(files["sk2"]), jsch.ctx)
    standins.install(monkeypatch.setattr)
    L = sch.params.num_q
    rng = np.random.default_rng(5)
    for call in range(RUNS):
        pt = sch.make_plaintext([rng.uniform(-1, 1, sch.encoder.slots) for _ in range(3)])
        seeds = [bytes([call, i]) * 8 for i in range(3)]
        draws = Draws(monkeypatch, seed=call)
        got = sch.encrypt_sk(sk, pt, torch.Generator(), seeds)
        assert draws.calls() == {"discrete_gaussian": 1}
        draws.feed_jax()
        for i, sd in enumerate(seeds):
            jpt = JaxPt(jnp.asarray(convert.residues_np(pt.data[i])), pt.scale)
            want = japi._encrypt_sk_with_a(jsch.ctx, jsk, jpt, None,
                                           jrlwe.expand_a(jsch.ctx, sd, L))
            np.testing.assert_array_equal(convert.residues_np(got.data[i]), np.asarray(want))
        assert not any(draws.queue.values())
    (op,) = [op for k, op in sch._graphs.items() if k[0] == ("encrypt_sk", L)]
    assert op.graph is not None and op.replays == RUNS - WARMUP
    api._scheme_for.cache_clear()
