"""The program's own spans in a traced run, and what the ``program_span``
metrics read of them.

The program (``ppqsflhe_tpu_torch.utils.profiling``) records spans only
inside ``profiling.tracing()``; every timed round runs with it off. The
first such metric a traced run reads runs :func:`phase` once, after the
window, the check and every other reading, on the cell and seed of the
command line: the cell's world made again from the seed, its round
captured untraced (the timed graph) and its outputs kept, that graph
released and the round captured again with tracing on, so the device spans
inside it are event-record nodes of the graph; then ``spans`` ×
``span_rounds`` rounds of the cell's plan with tracing on, each round's
spans collected, and one more ``span_rounds`` under ``torch.profiler``
(CUDA activities, as ``trace.py`` reads them). Each device span adds two
event nodes to the graph, and each node holds the next kernel back a few
µs; so the round is captured and run twice: once without the ``ntt`` spans
(:data:`COARSE`, nine of a pairwise round's 19), which every metric but
``ntt.device_ms`` reads and the profiled span runs, and once with every
span. Each instrumented round's outputs on the untraced round's input set
must equal the untraced graph's (``torch.equal``; the INDCPA round draws
nothing), or the run fails. Notes go to standard error: every span's self
time a round (its device time less its children's) in each capture, and
of the profiled span the ``round`` span beside its kernels' extent and the
device busy, and the idle ms a round by the innermost program host span at
each gap's middle.

A program without the recorder (no ``profiling.tracing``) runs no phase and
its metrics read None."""

from __future__ import annotations

import argparse
import collections
import gc
import json
import sys
import types
from pathlib import Path

OUTSIDE = "(outside the program)"


def command_line():
    """(cell, seed) of this process's ``--workload`` and ``--seed``, or None."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    args, _ = ap.parse_known_args(sys.argv[1:])
    return None if args.workload is None or args.seed is None else (args.workload, args.seed)


def recorder():
    """The program's span recorder, or None where the program has none."""
    from ppqsflhe_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "tracing") else None


COARSE = ("ntt",)    # spans left out of the capture most metrics read


def phase(cfg: dict, traffic: dict, plan: dict, seed: int, device):
    """The program-span phase of a cell (see the module's docstring) → its
    readings: ``rounds`` (the traced rounds of each capture), the spans of
    the capture without :data:`COARSE` (``records``) and with every span
    (``full``), ``latency_ms`` (each call of the first between CUDA
    events), and of its profiled span the ``profiled`` records and the
    ``trace`` (a :class:`benchmark.trace.Span`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import generator, run
    from benchmark import trace as tr

    profiling = recorder()
    device = torch.device(device)
    entry, out, _, _, _ = run.set_up(cfg, traffic, generator.streams(seed), device, False)
    want = [(t.clone(), s) for t, s in out]
    last = entry.sets - 1                     # the input set of ``out``
    out = None
    rounds = plan["spans"] * plan["span_rounds"]
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    got = {}
    for skip in (COARSE, ()):
        entry.round.graph.release()
        entry.round = None
        gc.collect()
        with profiling.tracing(skip):
            entry.start()
        torch.cuda.synchronize(device)
        profiling.collect()                   # the warm-up rounds' eager spans
        records, latency, equal = [], [], False
        for k in range(rounds):
            with profiling.tracing(skip):
                ev0.record()
                outs = entry(k)
                ev1.record()
            ev1.synchronize()
            latency.append(ev0.elapsed_time(ev1))
            records += profiling.collect()
            if k % entry.sets == last:
                equal = all(torch.equal(t, w) and s == ws for (t, s), (w, ws) in zip(outs, want))
        if not equal:
            raise RuntimeError(f"the round captured with tracing on (skipping {skip}) differs "
                               f"from the untraced round on input set {last}")
        got[skip] = records, latency
        if skip:
            with profile(activities=[ProfilerActivity.CUDA]) as prof, profiling.tracing(skip):
                for k in range(rounds, rounds + plan["span_rounds"]):
                    entry(k)
                    torch.cuda.synchronize(device)
            profiled = profiling.collect()
    entry.round.graph.release()
    del entry, outs, want
    gc.collect()
    torch.cuda.empty_cache()
    return types.SimpleNamespace(rounds=rounds, records=got[COARSE][0], full=got[()][0],
                                 latency_ms=got[COARSE][1], profiled=profiled,
                                 trace=tr.read(prof, plan["span_rounds"]))


def of(rec):
    """The phase's readings for the run ``rec`` (run once, kept on
    ``rec.program_spans``), or None: no recorder in the program, no card,
    or no cell on the command line."""
    if not hasattr(rec, "program_spans"):
        rec.program_spans = None
        import torch

        cl = command_line()
        if cl and recorder() and torch.cuda.is_available():
            from benchmark import run

            spec = json.loads((Path.cwd() / "BENCHMARK.json").read_text())
            _, cfg, traffic, plan = run.load(spec, cl[0], Path.cwd())
            rec.program_spans = phase(cfg, traffic, plan, cl[1], "cuda")
            for note in notes(rec.program_spans, getattr(rec, "spans", [])):
                print(note, file=sys.stderr)
    return rec.program_spans


def device_ms(rec, name: str):
    """Device ms a round in the spans named ``name`` (of the capture with
    every span where :data:`COARSE` names them), or None."""
    ph = of(rec)
    ms = [r.device_ms for r in (ph.full if name in COARSE else ph.records)
          if r.name == name] if ph else []
    return sum(ms) / ph.rounds if ms else None


def by_round(records) -> dict:
    """{round: {name: [record, …]}}."""
    out = collections.defaultdict(lambda: collections.defaultdict(list))
    for r in records:
        out[r.round][r.name].append(r)
    return out


def host_ms(rec):
    """``round.call`` − ``round.load`` − ``round`` device ms a call, over
    the calls that have all three, or None: what the device waits on the
    host inside a call (the graph's launch), with no profiler running."""
    ph = of(rec)
    per = [c["round.call"][0].device_ms - c["round.load"][0].device_ms - c["round"][0].device_ms
           for c in (by_round(ph.records).values() if ph else [])
           if all(n in c for n in ("round.call", "round.load", "round"))]
    return sum(per) / len(per) if per else None


def self_ms(records, rounds: int) -> dict:
    """{name: device ms a round less what its children cover}; a host
    span's children count for its nearest ancestor with device time."""
    by_id = {r.id: r for r in records}
    kids = collections.defaultdict(float)
    for r in records:
        up = by_id.get(r.parent)
        while up is not None and up.device_ms is None:
            up = by_id.get(up.parent)
        if up is not None and r.device_ms is not None:
            kids[up.id] += r.device_ms
    out = collections.defaultdict(float)
    for r in records:
        if r.device_ms is not None:
            out[r.name] += (r.device_ms - kids[r.id]) / rounds
    return dict(out)


def idle_by_span(ph) -> dict:
    """{the innermost program host span at an idle gap's middle, or
    :data:`OUTSIDE`: idle ms a round} in the profiled span."""
    hosts = sorted((r for r in ph.profiled if r.host), key=lambda r: r.host[1] - r.host[0])
    span = ph.trace
    edges = [span.start] + [x for iv in span.busy() for x in iv] + [span.end]
    out = collections.defaultdict(float)
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            mid = (s + e) // 2
            name = next((r.name for r in hosts if r.host[0] <= mid < r.host[1]), OUTSIDE)
            out[name] += (e - s) / span.rounds / 1e6
    return dict(out)


def extent_ms(ph):
    """The profiled rounds' kernels from the first start to the last end,
    ms a round (the profile's view of the ``round`` span); a round's device
    events are those that start after its ``round.call`` host span does
    and before the next one's."""
    from benchmark.trace import is_copy

    starts = sorted(r.host[0] for r in ph.profiled if r.name == "round.call") + [float("inf")]
    out = []
    for a, b in zip(starts, starts[1:]):
        ks = [(s, e) for name, s, e in ph.trace.device if a <= s < b and not is_copy(name)]
        if ks:
            out.append((max(e for _, e in ks) - min(s for s, _ in ks)) / 1e6)
    return sum(out) / len(out) if out else None


def notes(ph, timed_spans) -> list:
    """The phase's lines for standard error: for each capture its device
    spans a round, its ``round`` span against the timed graph's device busy
    (``timed_spans``: the run's profiled spans of the timed graph) and every
    span's self ms a round; the profiled span's ``round`` against its
    device busy, and its idle ms by program host span."""
    rounds = sum(s.rounds for s in timed_spans)
    timed = sum(s.busy_ns() for s in timed_spans) / rounds / 1e6 if rounds else None
    fmt = lambda d: ", ".join(f"{k} {v:.4f}" for k, v in sorted(d.items(), key=lambda kv: -kv[1]))
    out = []
    for what, records in ((f"without {'/'.join(COARSE)}", ph.records), ("every span", ph.full)):
        rnd = sum(r.device_ms for r in records if r.name == "round") / ph.rounds
        spans = sum(r.device_ms is not None for r in records) / ph.rounds
        cost = (f", +{100 * (rnd / timed - 1):.2f}% over the timed graph's device busy "
                f"{timed:.4f}" if timed else "")
        out.append(f"program spans, {what}: {ph.rounds} rounds, {spans:.0f} device spans a "
                   f"round, 'round' {rnd:.4f} ms{cost}; self ms a round: "
                   + fmt(self_ms(records, ph.rounds)))
    n = ph.trace.rounds
    rnd = [r.device_ms for r in ph.profiled if r.name == "round"]
    extent = extent_ms(ph)
    out.append(f"program spans, profiled ({n} rounds, without {'/'.join(COARSE)}): 'round' "
               f"{sum(rnd) / len(rnd):.4f} ms a round, its kernels' extent "
               f"{extent if extent is None else round(extent, 4)}, device busy "
               f"{ph.trace.busy_ns() / n / 1e6:.4f}; idle ms a round by program host span: "
               + fmt(idle_by_span(ph)))
    return out
