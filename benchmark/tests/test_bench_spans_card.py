"""On the card (skipped without one): timing events captured into a CUDA
graph read each replay's time; each cell's program-span phase
(:func:`benchmark.spans.phase`, at the cell's own sizes) runs its round
captured with tracing on, without and with the ``ntt`` spans, bit-equal to
the untraced round (the phase raises otherwise), every ``cudaGraphLaunch``
of its profile lies inside a ``round.replay`` host span (the host stamps
share the profiler's clock),
each call's ``round`` span lies within the CUDA-event latency of the call,
and all six metrics read. Run on the card with
``python3 -m pytest benchmark/tests -m card``."""

import types

import pytest

from benchmark import run, spans
from benchmark.tests import cells


@pytest.mark.card
def test_timing_events_in_a_graph(card):
    import torch

    x = torch.ones(1 << 22, device=card)
    start, end = (torch.cuda.Event(enable_timing=True, external=True) for _ in range(2))
    torch.cuda.synchronize(card)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        start.record()
        for _ in range(20):
            x.mul_(1.0001)
        end.record()
    times = []
    for _ in range(3):
        g.replay()
        end.synchronize()
        times.append(start.elapsed_time(end))
    assert all(0 < t < 100 for t in times)


@pytest.mark.card
@pytest.mark.parametrize("cell", cells.CELLS)
def test_program_spans_on_the_card(card, cell):
    _, cfg, traffic, plan = run.load(cells.SPEC, cell, cells.ROOT)
    ph = spans.phase(cfg, traffic, plan, 2**31 + 101, card)
    launches = [(b, e) for name, b, e in ph.trace.host if name.startswith("cudaGraphLaunch")]
    replays = [r.host for r in ph.profiled if r.name == "round.replay"]
    assert len(launches) == len(replays) == plan["span_rounds"]
    assert all(any(h0 <= b and e <= h1 for h0, h1 in replays) for b, e in launches)
    calls = sorted(spans.by_round(ph.records).items())
    assert len(calls) == len(ph.latency_ms) == ph.rounds
    for latency, (_, c) in zip(ph.latency_ms, calls):
        assert 0 < c["round"][0].device_ms <= c["round.call"][0].device_ms <= latency
    assert not any(r.name == "ntt" for r in ph.records)
    assert len(spans.by_round(ph.full)) == ph.rounds and any(r.name == "ntt" for r in ph.full)
    rec = types.SimpleNamespace(program_spans=ph)
    for name in ("pre.decompose_ms", "pre.inner_product_ms", "pre.mod_down_ms",
                 "ntt.device_ms", "fedavg.device_ms", "server.host_ms"):
        v = run.load_module(run.HERE / "metrics" / f"{name}.py").read(rec)
        assert v is not None and v > 0, name
