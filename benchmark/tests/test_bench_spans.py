"""The ``program_span`` metrics (``benchmark/spans.py`` and the six metric
files that read it) on hand-made span records: each reads its span's
device ms a round (``server.host_ms`` a call's ``round.call`` less
``round.load`` and ``round``), None where the span is absent or no phase
ran; no phase runs without a cell on the command line or with a program
that has no span recorder; self times and the idle gaps by host span."""

import types

import pytest

from benchmark import run, spans
from benchmark.tests.cells import SPEC
from benchmark.trace import Span
from ppqsflhe_tpu_torch.utils import profiling
from ppqsflhe_tpu_torch.utils.profiling import Record

# each metric → its reading of :func:`one_round`'s records, ms a round
WANT = {"pre.decompose_ms": 2.5, "pre.inner_product_ms": 1.0, "pre.mod_down_ms": 1.5,
        "ntt.device_ms": 1.5, "fedavg.device_ms": 0.25, "server.host_ms": 0.125}


def one_round(rnd: int, base: int) -> list:
    """A round's records: call 6.5 = load 0.375 + host 0.125 + round 6
    (under the host span ``round.replay``); round = two pre + fedavg 0.25 +
    self 0.25; each pre 2.75: decompose 1.25 (ntt 0.5), inner product 0.5,
    mod down 0.75 (ntt 0.25), self 0.25."""
    r = lambda name, i, parent, ms, host=None: Record(name, base + i, None if parent is None
                                                      else base + parent, rnd, host, ms)
    recs = [r("round.call", 0, None, 6.5, (0, 9)), r("round.load", 1, 0, 0.375, (1, 2)),
            r("round.replay", 2, 0, None, (3, 8)), r("round", 3, 2, 6.0),
            r("fedavg", 4, 3, 0.25)]
    for p in (5, 11):
        recs += [r("pre", p, 3, 2.75), r("ks.decompose", p + 1, p, 1.25),
                 r("ntt", p + 2, p + 1, 0.5), r("ks.inner_product", p + 3, p, 0.5),
                 r("ks.mod_down", p + 4, p, 0.75), r("ntt", p + 5, p + 4, 0.25)]
    return recs


def record(records=None, rounds=2):
    """A run's record with the phase's readings: ``records`` in both
    captures (the one without ``ntt`` spans keeps them here too)."""
    rs = records if records is not None else one_round(1, 0) + one_round(2, 100)
    return types.SimpleNamespace(program_spans=types.SimpleNamespace(rounds=rounds, records=rs,
                                                                      full=rs))


def metric(name):
    return run.load_module(run.HERE / "metrics" / f"{name}.py")


def test_the_six_metrics_are_entries_of_the_benchmark():
    entries = {m["name"]: m for m in SPEC["per_layer"] if m["name"] in WANT}
    assert sorted(entries) == sorted(WANT)
    assert all(m["source"] == "program_span" and m["unit"] == "ms" and "workloads" not in m
               for m in entries.values())
    assert entries["server.host_ms"]["moves"] == "round_p95_ms"


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_metric_reads_its_span(name):
    assert metric(name).read(record()) == pytest.approx(WANT[name])


def test_ntt_reads_the_capture_with_every_span():
    rec = record()
    rec.program_spans.records = [r for r in rec.program_spans.records if r.name != "ntt"]
    assert metric("ntt.device_ms").read(rec) == pytest.approx(WANT["ntt.device_ms"])
    assert metric("pre.decompose_ms").read(rec) == pytest.approx(WANT["pre.decompose_ms"])


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_metric_without_its_span_reads_none(name):
    held = {"pre.decompose_ms": "ks.decompose", "pre.inner_product_ms": "ks.inner_product",
            "pre.mod_down_ms": "ks.mod_down", "ntt.device_ms": "ntt", "fedavg.device_ms": "fedavg",
            "server.host_ms": "round.load"}[name]
    left = [r for r in record().program_spans.records if r.name != held]
    assert metric(name).read(record(left)) is None
    assert metric(name).read(types.SimpleNamespace(program_spans=None)) is None


def test_no_phase_without_a_cell_on_the_command_line(monkeypatch):
    monkeypatch.setattr("sys.argv", ["pytest", "-q"])
    rec = types.SimpleNamespace(spans=[])
    assert spans.of(rec) is None and rec.program_spans is None


def test_no_phase_on_a_program_without_the_recorder(monkeypatch):
    """The parent of the recorder: ``profiling`` has no ``tracing``."""
    monkeypatch.setattr("sys.argv", ["run", "--workload", SPEC["workloads"][0]["name"],
                                     "--seed", "7"])
    monkeypatch.delattr(profiling, "tracing")
    assert spans.recorder() is None
    assert all(metric(n).read(types.SimpleNamespace(spans=[])) is None for n in WANT)


def test_self_times():
    got = spans.self_ms(record().program_spans.records, 2)
    assert got == pytest.approx({"round.call": 0.125, "round.load": 0.375, "round": 0.25,
                                 "fedavg": 0.25, "pre": 0.5, "ks.decompose": 1.5,
                                 "ks.inner_product": 1.0, "ks.mod_down": 1.0, "ntt": 1.5})


def test_idle_gaps_by_the_innermost_host_span():
    """Busy 2–4 and 6–9 ns of a 0–12 window over one round: the gap 0–2
    falls in ``round.load``, 4–6 in ``round.replay`` (inside
    ``round.call``), 9–12 outside the program."""
    recs = [Record("round.call", 0, None, 1, (0, 8)), Record("round.load", 1, 0, 1, (0, 2)),
            Record("round.replay", 2, 0, 1, (4, 7))]
    trace = Span(1, 0, 12, device=[("k", 2, 4), ("k", 6, 9)])
    ph = types.SimpleNamespace(profiled=recs, trace=trace)
    assert spans.idle_by_span(ph) == pytest.approx(
        {"round.load": 2e-6, "round.replay": 2e-6, spans.OUTSIDE: 3e-6})


def test_kernel_extent_by_round():
    """Two rounds: kernels 2–5 and 11–16 ns after calls at 0 and 10 (a copy
    at 1–9 left out): extents 3 and 5 ns."""
    recs = [Record("round.call", 0, None, 1, (0, 8)), Record("round.call", 1, None, 1, (10, 18))]
    device = [("Memcpy DtoD", 1, 9), ("k", 2, 4), ("k", 4, 5), ("k", 11, 16)]
    ph = types.SimpleNamespace(profiled=recs, trace=Span(2, 0, 20, device=device))
    assert spans.extent_ms(ph) == pytest.approx(4e-6)
