"""The program's spans (``ppqsflhe_tpu_torch/utils/profiling.py``) on the
CPU, where a device span's events are host-clock stand-ins and a CUDA
graph is ``tests/torch_graph_standins.py``'s: off by default (no event, no
clock read, no record, a graph captured as before); spans nest, name their
parent and share their call's round; their host stamps bracket a
``torch.profiler`` event recorded inside them (the profiler's clock); a
traced round gives the untraced round's residues; each replay of a graph
captured with tracing on queues one set of the spans captured in it. The
same on the card (events in a real graph, the ``cudaGraphLaunch`` inside
``round.replay``) is ``benchmark/tests/test_bench_spans_card.py``."""

import collections
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ppqsflhe_tpu_torch.bench import multikey as mk
from ppqsflhe_tpu_torch.ckks import eval as ev
from ppqsflhe_tpu_torch.ckks.params import CkksParams
from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
from ppqsflhe_tpu_torch.ckks.types import Ciphertext
from ppqsflhe_tpu_torch.fl import api, compiled
from ppqsflhe_tpu_torch.utils import graphs, profiling

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_graph_standins as standins  # noqa: E402

N, B = 256, 2
# the spans of one pairwise round at lazy-4 on the 4-tower chain: PRE at 3
# limbs (digits [2, 1]: an inverse and two forward transforms to decompose),
# PRE back at 2 (one digit); each ModDown an inverse and a forward
LAZY4_SPANS = {"round": 1, "pre": 2, "ks.decompose": 2, "ks.inner_product": 2,
               "ks.mod_down": 2, "ntt": 9, "fedavg": 1}


@pytest.fixture(scope="module")
def pair():
    """A 4-tower (FLEXIBLEAUTOEXT) scheme at N = 256 with two clients'
    Montgomery rekeys and B ciphertexts each."""
    sch = CkksScheme(CkksParams.generate(n=N, mult_depth=2, scale_bits=40, dnum=2,
                                         slots=N // 2, extra_mod_bits=20), device="cpu")
    gen = torch.Generator().manual_seed(5)
    (sk1, pk1), (sk2, pk2) = sch.keygen(gen), sch.keygen(gen)
    rk12 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk1, pk2, gen))
    rk21 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk2, pk1, gen))
    rng = np.random.default_rng(5)
    c1, c2 = (sch.encrypt_values(pk, [rng.uniform(-1, 1, N // 2) for _ in range(B)], gen)
              for pk in (pk1, pk2))
    return sch, rk12, rk21, c1, c2


@pytest.fixture(scope="module")
def many(pair):
    """Three clients (hub last) on ``pair``'s scheme: the rekeys into the
    hub and back, and the stacks at each schedule's inbound level."""
    sch = pair[0]
    gen = torch.Generator().manual_seed(6)
    keys = [sch.keygen(gen) for _ in range(3)]
    rk_to = [ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk, keys[-1][1], gen)) for sk, _ in keys[:-1]]
    rk_from = [ev.ksk_to_mont(sch.ctx, sch.rekey_gen(keys[-1][0], pk, gen))
               for _, pk in keys[:-1]]
    rng = np.random.default_rng(6)
    cts = [sch.encrypt_values(pk, [rng.uniform(-1, 1, N // 2) for _ in range(B)], gen)
           for _, pk in keys]
    full = Ciphertext(torch.stack([c.data for c in cts]), cts[0].scale)
    return sch, rk_to, rk_from, {lazy: mk.stage(full, mk.inbound_level(sch, lazy))
                                 for lazy in (4, 0)}


@pytest.fixture(autouse=True)
def empty():
    """Each test starts and ends with no span kept."""
    profiling.collect()
    yield
    profiling.collect()


def stand_in_round(sch, rk12, rk21, lazy, c1):
    """``CompiledRound`` over the stand-in capture, as its constructor
    builds it (which refuses a CPU scheme)."""
    cr = compiled.CompiledRound.__new__(compiled.CompiledRound)
    cr.sch, cr.lazy, cr.scale, cr.rk12, cr.rk21 = sch, lazy, c1.scale, rk12, rk21
    cr.stack1 = torch.zeros_like(c1.data)
    cr.stack2 = torch.zeros_like(c1.data)
    graphs.warm_up(cr._round, "cpu", graphs.WARMUP)
    cr.graph = graphs.Graph(cr._round, "the server round")
    cr.avg, cr.back = cr.graph.output
    cr.launches = cr.graph.launches
    return cr


def stand_in_multikey(sch, rk_to, rk_from, lazy, stacks):
    """``CompiledMultikeyRound`` over the stand-in capture."""
    cr = mk.CompiledMultikeyRound.__new__(mk.CompiledMultikeyRound)
    cr.sch, cr.lazy, cr.scale, cr.rk_to, cr.rk_from = sch, lazy, stacks.scale, rk_to, rk_from
    cr.stacks = torch.zeros_like(stacks.data)
    graphs.warm_up(cr._round, "cpu", graphs.WARMUP)
    cr.graph = graphs.Graph(cr._round, "the multikey round")
    cr.launches = cr.graph.launches
    return cr


def equal(a, b) -> bool:
    return all(torch.equal(x.data, y.data) and x.scale == y.scale for x, y in zip(a, b))


class NoEvent:
    def __init__(self, *args, **kwargs):
        raise AssertionError("an event was created with tracing off")


@pytest.mark.parametrize("which", ["pairwise", "multikey"])
def test_off_no_event_no_record_and_the_same_graph(pair, many, monkeypatch, which):
    """Tracing off through a whole compiled round (warm-up, capture, three
    calls): no event created, no clock read, no span kept, and the graph
    holds no span; traced, the graph holds its spans, the same launches
    and gives the same residues."""
    standins.install(monkeypatch.setattr)
    sch, rk12, rk21, c1, c2 = pair
    _, rk_to, rk_from, stacks = many
    make = (lambda: stand_in_round(sch, rk12, rk21, 4, c1)) if which == "pairwise" else (
        lambda: stand_in_multikey(sch, rk_to, rk_from, 4, stacks[4]))
    call = (lambda cr: cr(c1, c2)) if which == "pairwise" else (lambda cr: cr(stacks[4]))
    with monkeypatch.context() as mp:
        mp.setattr(profiling, "HostEvent", NoEvent)
        mp.setattr(torch.cuda, "Event", NoEvent)
        mp.setattr(profiling, "clock", NoEvent)
        off = make()
        outs_off = [[(o.data.clone(), o.scale) for o in call(off)] for _ in range(3)]
    assert off.graph.spans == [] and profiling.collect() == []
    with profiling.tracing():
        on = make()
        outs_on = [[(o.data.clone(), o.scale) for o in call(on)] for _ in range(3)]
    assert on.graph.spans and on.launches == off.launches
    for a, b in zip(outs_off, outs_on):
        assert all(torch.equal(x, y) and s == t for (x, s), (y, t) in zip(a, b))
    assert len(profiling.collect()) > 0


def test_off_span_is_one_shared_noop():
    assert profiling.span("a") is profiling.span("b", device=False)
    with profiling.span("a"):
        pass
    assert profiling.collect() == []


def test_spans_nest_name_their_parent_and_share_the_round():
    with profiling.tracing():
        for _ in range(2):
            with profiling.span("call"):
                with profiling.span("load"):
                    pass
                with profiling.span("replay", device=False):
                    with profiling.span("inner"):
                        pass
    recs = profiling.collect()
    by_id = {r.id: r for r in recs}
    assert [r.name for r in recs] == ["load", "inner", "replay", "call"] * 2
    calls = [r for r in recs if r.name == "call"]
    assert [c.parent for c in calls] == [None, None] and calls[0].round != calls[1].round
    for r in recs:
        if r.name != "call":
            root = r
            while root.parent is not None:
                root = by_id[root.parent]
            assert root.name == "call" and r.round == root.round
    assert all(by_id[r.parent].name == "replay" for r in recs if r.name == "inner")
    assert all((r.device_ms is None) == (r.name == "replay") for r in recs)
    for r in recs:
        assert r.host[0] <= r.host[1]
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.host[0] <= r.host[0] and r.host[1] <= p.host[1]


def test_host_stamps_bracket_a_profiler_event():
    """Under a CPU profiler a span opens a ``record_function`` range of its
    name; the span's host stamps bracket that range and one recorded
    inside it: the stamps are on the profiler's clock."""
    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.tracing():
        with profiling.span("outer"):
            with record_function("inside"):
                torch.ones(256).cumsum(0)
    (rec,) = profiling.collect()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for name in ("outer", "inside"):
        e = events[name]
        assert rec.host[0] <= e.start_ns() <= e.end_ns() <= rec.host[1], name


@pytest.mark.parametrize("lazy", [4, 0])
def test_traced_pairwise_round_is_bit_equal(pair, lazy):
    """``fl.api.server_round`` traced gives the untraced residues; its
    spans at lazy-4 are those of the 4-tower chain's round, each key-switch
    stage inside a ``pre``, every span inside ``round``."""
    sch, rk12, rk21, c1, c2 = pair
    plain = api.server_round(sch, c1, c2, rk12, rk21, lazy)
    with profiling.tracing():
        traced = api.server_round(sch, c1, c2, rk12, rk21, lazy)
    recs = profiling.collect()
    assert equal(plain, traced)
    names = collections.Counter(r.name for r in recs)
    if lazy == 4:
        assert names == LAZY4_SPANS
    else:                       # both digits at 4 limbs in, 3 back; the rescale's two transforms
        assert names["pre"] == 2 and names["fedavg"] == 1 and names["ntt"] == 5 + 5 + 2
    by_id = {r.id: r for r in recs}
    assert all(by_id[r.parent].name == "pre" for r in recs if r.name.startswith("ks."))
    assert len({r.round for r in recs}) == 1
    assert [r.name for r in recs if r.parent is None] == ["round"]


@pytest.mark.parametrize("lazy", [4, 0])
def test_traced_multikey_round_is_bit_equal(many, lazy):
    """``bench.multikey.server_round`` traced gives the untraced residues:
    a ``pre`` for each of 2(C−1) key switches, a ``fedavg`` for each
    client's add and one for the ÷C."""
    sch, rk_to, rk_from, stacks = many
    plain = mk.server_round(sch, stacks[lazy], rk_to, rk_from, lazy)
    with profiling.tracing():
        traced = mk.server_round(sch, stacks[lazy], rk_to, rk_from, lazy)
    names = collections.Counter(r.name for r in profiling.collect())
    assert equal(plain, traced)
    assert names["round"] == 1 and names["pre"] == 4 and names["fedavg"] == 3
    assert names["ks.decompose"] == names["ks.inner_product"] == names["ks.mod_down"] == 4


def test_skipped_spans_are_not_recorded(pair, monkeypatch):
    """``tracing(skip)`` leaves the named spans out of a capture: the
    graph holds the round's spans but the ``ntt`` ones, and gives the same
    residues."""
    standins.install(monkeypatch.setattr)
    sch, rk12, rk21, c1, c2 = pair
    with profiling.tracing(skip=("ntt",)):
        cr = stand_in_round(sch, rk12, rk21, 4, c1)
        profiling.collect()
        got = cr(c1, c2)
    names = collections.Counter(c.name for c in cr.graph.spans)
    assert names == {k: v for k, v in LAZY4_SPANS.items() if k != "ntt"}
    assert not any(r.name == "ntt" for r in profiling.collect())
    assert equal(api.server_round(sch, c1, c2, rk12, rk21, 4), got)


def test_a_child_lies_inside_its_parent(pair):
    """Host-clock device times: each span's time covers its children's."""
    sch, rk12, rk21, c1, c2 = pair
    with profiling.tracing():
        api.server_round(sch, c1, c2, rk12, rk21, 4)
    recs = profiling.collect()
    kids = collections.defaultdict(float)
    for r in recs:
        if r.parent is not None:
            kids[r.parent] += r.device_ms
    assert all(r.device_ms >= kids[r.id] >= 0 for r in recs)


def test_every_replay_queues_one_set_of_the_captured_spans(pair, monkeypatch):
    """A compiled round captured with tracing on: each call keeps its
    ``round.call``, ``round.load`` and ``round.replay`` and one set of the
    captured spans, under the call's round, the captured ``round`` a child
    of ``round.replay``."""
    standins.install(monkeypatch.setattr)
    sch, rk12, rk21, c1, c2 = pair
    with profiling.tracing():
        cr = stand_in_round(sch, rk12, rk21, 4, c1)
        assert collections.Counter(c.name for c in cr.graph.spans) == LAZY4_SPANS
        profiling.collect()                     # the warm-up rounds' eager spans
        for _ in range(3):
            cr(c1, c2)
    recs = profiling.collect()
    rounds = collections.defaultdict(list)
    for r in recs:
        rounds[r.round].append(r)
    assert len(rounds) == 3
    for rs in rounds.values():
        names = collections.Counter(r.name for r in rs)
        assert names == collections.Counter(LAZY4_SPANS) + collections.Counter(
            {"round.call": 1, "round.load": 1, "round.replay": 1})
        by_name = {r.name: r for r in rs}
        assert by_name["round"].parent == by_name["round.replay"].id
        assert by_name["round.replay"].parent == by_name["round.call"].id
        assert by_name["round"].host is None and by_name["round.replay"].device_ms is None
        assert all(r.device_ms is not None for r in rs if r.name != "round.replay")


def test_a_replay_is_read_before_the_next_records_it_again():
    """Two replays of one captured set with no collect between: the first
    replay's times are read when the second is queued."""
    with profiling.tracing():
        with profiling.capturing() as spans:
            with profiling.span("a"):
                pass
        profiling.queue(spans)
        profiling.queue(spans)
        spans[0].end.t += 5_000_000     # the second replay records the end event again
    a, b = profiling.collect()
    assert a.round != b.round
    assert b.device_ms - a.device_ms == pytest.approx(5.0)


def test_the_buffer_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(profiling, "LIMIT", 3)
    monkeypatch.setattr(profiling, "_rec", profiling._Recorder())
    with profiling.tracing():
        for i in range(5):
            with profiling.span(f"s{i}"):
                pass
    assert [r.name for r in profiling.collect()] == ["s2", "s3", "s4"]


def test_no_span_is_captured_while_tracing_is_off():
    with profiling.capturing() as spans:
        with profiling.span("a"):
            pass
    profiling.queue(spans)
    assert spans == [] and profiling.collect() == []
