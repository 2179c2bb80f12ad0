"""The benchmark cell ``pairwise-n16.gru27.full`` on the CPU: upstream's full
pairwise round and chain (60/40/40/20 + 2 × 60) with 8192 slots, the ring
raised to N = 2^16, so sparse packing, through ``fl.api.server_round``.
There each transform splits its limbs over three routes (q0, p0, p1 big:
kernels 4 + 5; q1, q2 Montgomery: kernel 1b; q_ext kernel 1), here through
their plain versions, and the big and Montgomery groups open the spans that
the cell's ``ntt.big_ms`` and ``ntt.mont_ms`` read. The outputs, decrypted
by the benchmark's plain reference under the test's own secrets, hold the
cell's limits. The kernels at these shapes are held to their plain versions
on the card (``tests/test_torch_pairwise_n16_card.py``)."""

from pathlib import Path
import json
import types

import numpy as np
import pytest
import torch

from benchmark import generator, program, run, spans
from benchmark.entries import pairwise
from benchmark.reference import chain as rchain
from benchmark.reference import judge
from ppqsflhe_tpu_torch.ckks.types import Ciphertext
from ppqsflhe_tpu_torch.ops import cuda_mxu_ntt
from ppqsflhe_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "pairwise-n16.gru27.full"
TWIN = "pairwise-n14.gru27.full"   # the same round, chain and slots at N = 2^14
ROUTE_METRICS = ("ntt.big_ms", "ntt.mont_ms")
N = 1 << 16
SEED = 2**40 + 11                  # a seed as large as the harness's
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread for this module: its int64 passes over 2^16
    coefficients run no faster on more, and threads of several test
    workers on one host's cores slow each other tenfold and more."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def cell():
    """(configuration, traffic, plan) as the harness loads the cell."""
    return run.load(SPEC, CELL, ROOT)[1:]


@pytest.fixture(scope="module")
def scheme(cell):
    return program.scheme(cell[0], CPU)


@pytest.fixture(scope="module")
def twin_scheme():
    return program.scheme(run.load(SPEC, TWIN, ROOT)[1], CPU)


def test_the_cell_loads_as_stated(cell):
    """The cell is the N = 2^14 full round's configuration with only the
    ring raised, under its traffic unchanged: 4 input sets × 2 clients ×
    27 uniform(−1, 1) vectors of 8192 slots."""
    cfg, traffic, plan = cell
    twin = run.load(SPEC, TWIN, ROOT)[1]
    same = ("entry", "clients", "multiplicative_depth", "first_mod_size", "scaling_mod_size",
            "scaling_technique", "extra_mod_size", "dnum", "batch_size", "PREMode",
            "ntt_backend", "ntt_impl", "control", "reduced")
    assert {k: cfg[k] for k in same} == {k: twin[k] for k in same}
    assert (cfg["ring_dim"], cfg["batch_size"]) == (N, 8192)
    assert traffic == run.load(SPEC, TWIN, ROOT)[2]
    assert plan["limits"]["limb_mismatch"] == plan["limits"]["scale_gap"] == 0
    sets = generator.payloads(generator.streams(SEED)[1], traffic, cfg["clients"],
                              cfg["batch_size"])
    assert np.shape(sets) == (4, 2, 27, 8192)
    assert np.abs(sets).max() <= 1


def test_only_the_cell_reports_the_route_metrics():
    """``ntt.big_ms`` and ``ntt.mont_ms`` are per-layer metrics of this
    cell alone; it reports every per-layer metric the other cells do."""
    ours = [m[0] for m in run.metrics(SPEC, "per_layer", CELL)]
    for w in SPEC["workloads"]:
        theirs = [m[0] for m in run.metrics(SPEC, "per_layer", w["name"])]
        assert not set(ROUTE_METRICS) & set(theirs) or w["name"] == CELL
        assert set(theirs) <= set(ours)
    assert set(ROUTE_METRICS) <= set(ours)


@pytest.mark.parametrize("name", ROUTE_METRICS)
def test_a_route_metric_without_its_span_reads_none(monkeypatch, name):
    """On a program that opens no route span (as at N = 2^14, or before
    the spans were added) the metric reads None, so the line leaves it out."""
    ph = types.SimpleNamespace(rounds=2, records=[profiling.Record("ntt", 0, None, 0, None, 1.0)],
                               full=[])
    monkeypatch.setattr(spans, "of", lambda rec: ph)
    assert run.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py").read(object()) is None


def _spans(sch, idx):
    """Names of the spans one forward and one inverse transform of the
    limbs ``idx`` record under tracing."""
    x = torch.zeros((1, len(idx), sch.params.n), dtype=torch.int64)
    profiling.collect()
    with profiling.tracing():
        sch.ctx.intt(sch.ctx.ntt(x, idx), idx)
    return sorted(r.name for r in profiling.collect())


def test_route_spans_open_only_where_the_limbs_split(scheme, twin_scheme):
    """At N = 2^16 a transform of the whole QP basis opens ``ntt.big``
    (q0, p0, p1) and ``ntt.mont`` (q1, q2) inside ``ntt``, one each a
    transform; one route's limbs alone open neither, nor does any transform
    at N = 2^14, where every limb takes kernel 1."""
    every = tuple(range(len(scheme.ctx.fntt.tabs)))
    assert _spans(scheme, every) == ["ntt", "ntt", "ntt.big", "ntt.big", "ntt.mont", "ntt.mont"]
    assert _spans(scheme, (1, 2)) == ["ntt", "ntt"]
    assert _spans(twin_scheme, tuple(range(len(twin_scheme.ctx.fntt.tabs)))) == ["ntt", "ntt"]


def test_the_chain_is_the_programs(cell, scheme):
    """The reference works out the program's moduli at N = 2^16: the
    extension prime is the first ≡ 1 mod 2^17 from 2^19 up, not upstream's
    557057 (≡ 1 mod 2^15 only), and the limbs take all three routes."""
    c = rchain.of(cell[0])
    assert (c.q, c.p) == (scheme.params.q_moduli, scheme.params.p_moduli)
    assert c.q[-1] == 786433 == rchain.prime_from(20, 1 << 17)
    assert (557057 - 1) % (1 << 17)
    routes = [cuda_mxu_ntt.route(c.n, t.nd) for t in scheme.ctx.fntt.tabs]
    assert routes == ["big", "fused_mont", "fused_mont", "fused", "big", "big"]


@pytest.fixture(scope="module")
def outputs(cell, scheme):
    """One seeded ciphertext a client through the full round → (secrets,
    payloads, the average in client 1's domain, its re-encryption into
    client 0's)."""
    cfg, traffic, _ = cell
    traffic = dict(traffic, payload=dict(traffic["payload"], count=1), input_sets=1)
    sec, pay, _, tseed = generator.streams(SEED)
    secrets = generator.secrets(sec, cfg["clients"], N)
    payloads = generator.payloads(pay, traffic, cfg["clients"], cfg["batch_size"])
    gen = torch.Generator().manual_seed(tseed)
    entry = pairwise.Entry(scheme, program.keys(scheme, secrets, gen), payloads,
                           traffic["lazy"], gen)
    avg, back = entry.eager()(Ciphertext(entry.pool0[0], entry.scale),
                              Ciphertext(entry.pool1[0], entry.scale))
    return secrets, payloads, avg, back


def test_the_round_ends_at_the_fresh_level(cell, outputs):
    """Both outputs hold one ciphertext at the level and scale the judge
    decodes them at: 3 limbs (q_ext rescaled away) at the fresh scale."""
    cfg, traffic, _ = cell
    limbs, scale, _ = judge.plan(rchain.of(cfg), cfg["scaling_mod_size"], cfg["clients"],
                                 traffic["lazy"])
    _, _, avg, back = outputs
    assert tuple(avg.data.shape) == (1, 2, limbs, N) == tuple(back.data.shape)
    assert limbs == 3 and avg.scale == back.scale == scale


def test_the_round_is_judged_correct(cell, outputs):
    """The outputs, decoded from 8192 sparse slots, hold the cell's limits
    against the plain FedAvg."""
    cfg, traffic, plan = cell
    secrets, payloads, avg, back = outputs
    chain = rchain.of(cfg)
    limbs, scale, factor = judge.plan(chain, cfg["scaling_mod_size"], cfg["clients"],
                                      traffic["lazy"])
    dec = judge.Decryptor(chain, cfg["ntt_backend"], secrets, cfg["batch_size"], CPU)
    res = judge.judge(dec, ((avg.data, avg.scale), (back.data.unsqueeze(0), back.scale)),
                      factor * judge.fedavg(payloads[0]), cfg["clients"] - 1, limbs, scale)
    assert res["limb_mismatch"] == 0
    assert all(res[k] <= limit for k, limit in plan["limits"].items()), res
    assert 0 < res["max_err"]
