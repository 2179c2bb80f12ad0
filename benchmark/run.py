"""The benchmark of ``ppqsflhe_tpu_torch``: one cell, one run.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic and
its metrics are found by name: ``BENCHMARK.json`` names the cell's
configuration file (``benchmark/configs/``) and traffic
(``benchmark/traffic/<traffic>.json``); the cell's own file
(``benchmark/workloads/<cell>.json``) holds the limits of its check and how
its traced run samples; each metric is ``benchmark/metrics/<metric>.py``
(a ``read(record)`` that returns the number or None); the configuration's
``entry`` is ``benchmark/entries/<entry>.py``.

A run makes the secrets, payloads and encryptions from the seed, builds the
cell's compiled round (set-up ends after every input set has gone through
it once), then runs a closed loop of rounds, one in flight, for
``--seconds``. With ``--trace 1`` a few spans of the window run under
``torch.profiler`` and the per-layer metrics are read from them; otherwise
the end-to-end metrics. After the window the outputs of a sample of rounds
(drawn from the seed) and of the last round are judged by the plain
reference (``benchmark/reference/``), once the program's state is freed.
The last line of standard output is one JSON object; the numbers compared
and their limits are the last lines of standard error."""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "ppqsflhe_tpu"}
HERE = Path(__file__).resolve().parent


def cache_dirs(root: Path) -> None:
    """Every compile cache under the checkout, at fixed paths (the port's
    own kernel library builds into ``build/ppqsflhe_tpu_torch/`` there)."""
    base = root / "build" / "benchmark-cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def pin() -> None:
    """The whole process on one core, its second allowed one (threads made
    later inherit it): a round of a small cell waits on the host's graph
    launch, whose speed otherwise changes with the cores a run lands on."""
    cpus = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cpus[1] if len(cpus) > 1 else cpus[0]})


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"benchmark._{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def by_name(items, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"benchmark: no {what} named {name!r} in BENCHMARK.json")


def load(spec: dict, name: str, root: Path) -> tuple:
    """(cell, configuration, traffic, plan) of the cell ``name``."""
    cell = by_name(spec["workloads"], name, "workload")
    cfg = json.loads((root / by_name(spec["configs"], cell["config"], "configuration")["file"])
                     .read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    plan = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    return cell, cfg, traffic, plan


def metrics(spec: dict, kind: str, cell: str) -> list:
    """[(name, unit, reader)] of the ``kind`` metrics the cell reports: every
    one, or where a metric lists its ``workloads``, those cells alone."""
    return [(m["name"], m["unit"], load_module(HERE / "metrics" / f"{m['name']}.py"))
            for m in spec[kind] if cell in m.get("workloads", [cell])]


class HostEvent:
    """A stand-in for a CUDA event where the program runs on the CPU."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


class Loop:
    """The closed loop: one round in flight, each round's latency from a
    pair of CUDA events, and a uniform sample of ``keep`` rounds' outputs
    (reservoir sampling on ``rng``) copied aside for the check."""

    def __init__(self, entry, out, keep: int, rng, device):
        import torch

        self.entry, self.out, self.rng = entry, out, rng
        self.kept = [tuple(torch.empty_like(t) for t, _ in out) for _ in range(keep)]
        self.kept_meta = [None] * keep
        on_card = torch.device(device).type == "cuda"
        self.ev0, self.ev1 = ((torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True)) if on_card
                              else (HostEvent(), HostEvent()))
        self.latency_ms, self.rounds = [], 0

    def one(self) -> None:
        self.ev0.record()
        self.out = self.entry(self.rounds)
        self.ev1.record()
        self.ev1.synchronize()
        self.latency_ms.append(self.ev0.elapsed_time(self.ev1))
        k, keep = self.rounds, len(self.kept)
        j = k if k < keep else int(self.rng.integers(0, k + 1))
        if j < keep:
            for dst, (src, _) in zip(self.kept[j], self.out):
                dst.copy_(src)
            self.kept_meta[j] = (k % self.entry.sets, tuple(s for _, s in self.out))
        self.rounds += 1

    def samples(self) -> list:
        """[(input set, ((average, scale), (re-encryptions, scale)))] of the
        kept rounds and the last one."""
        last = ((self.rounds - 1) % self.entry.sets, tuple((t.clone(), s) for t, s in self.out))
        return [(m[0], tuple(zip(self.kept[j], m[1])))
                for j, m in enumerate(self.kept_meta) if m] + [last]


def set_up(cfg: dict, traffic: dict, streams, device, trace: bool):
    """The program's world from the seed's streams, the cell's compiled
    round, and every input set through it once → (entry, last outputs,
    secrets, payloads, [(step, end time)])."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import generator, program

    sec_rng, pay_rng, _, tseed = streams
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    secrets = generator.secrets(sec_rng, cfg["clients"], cfg["ring_dim"])
    payloads = generator.payloads(pay_rng, traffic, cfg["clients"], cfg["batch_size"])
    marks = [("imports", time.perf_counter())]
    sch = program.scheme(cfg, device)
    gen = torch.Generator(device=device).manual_seed(tseed)
    keys = program.keys(sch, secrets, gen)
    sync()
    marks.append(("scheme and keys", time.perf_counter()))
    entries = importlib.import_module(f"benchmark.entries.{cfg['entry']}")
    entry = entries.Entry(sch, keys, payloads, traffic["lazy"], gen)
    sync()
    marks.append(("rekeys and encryptions", time.perf_counter()))
    entry.start()
    marks.append(("warm-up and capture", time.perf_counter()))
    for k in range(entry.sets):          # every input set through the timed call once
        out = entry(k)
    sync()
    if trace:                            # the profiler's own first start (seconds of CUPTI set-up)
        with profile(activities=[ProfilerActivity.CUDA]):
            out = entry(0)
            sync()
    marks.append(("first calls", time.perf_counter()))
    return entry, out, secrets, payloads, marks


def check(cfg: dict, traffic: dict, limits: dict, chain, secrets, payloads, samples,
          device) -> tuple:
    """The plain reference's verdict on the sampled rounds → (checks {name:
    {value, limit}}, rounds that failed)."""
    from benchmark.reference import judge

    limbs, scale, factor = judge.plan(chain, cfg["scaling_mod_size"], cfg["clients"],
                                      traffic["lazy"])
    dec = judge.Decryptor(chain, cfg["ntt_backend"], secrets, cfg["batch_size"], device)
    found, failed = [], 0
    for s, outputs in samples:
        res = judge.judge(dec, outputs, factor * judge.fedavg(payloads[s]), cfg["clients"] - 1,
                          limbs, scale)
        failed += any(not res[k] <= limits[k] for k in res)
        found.append(res)
    return {k: {"value": max(r[k] for r in found), "limit": limits[k]} for k in found[0]}, failed


def run(cell: dict, cfg: dict, traffic: dict, plan: dict, metrics: list, seed: int,
        seconds: float, trace: bool, device, t0: float = T0) -> dict:
    """One run of ``cell`` → the result line's object, with ``notes`` (lines
    for standard error) beside it; ``metrics`` is [(name, unit, reader)]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import generator, work
    from benchmark import trace as tr
    from benchmark.reference import chain as rchain

    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    streams = generator.streams(seed)
    entry, out, secrets, payloads, marks = set_up(cfg, traffic, streams, device, trace)
    setup_s = marks[-1][1] - t0

    loop = Loop(entry, out, plan["check_rounds"], streams[2], device)
    del out
    span_at = [seconds * (j + 1) / (plan["spans"] + 1) for j in range(plan["spans"])] \
        if trace else []
    spans, span_s = [], []
    t_start = time.perf_counter()
    untraced = lambda: time.perf_counter() - t_start - sum(span_s)     # noqa: E731
    while loop.rounds == 0 or untraced() < seconds:
        if span_at and untraced() >= span_at[0]:
            span_at.pop(0)
            ts, r0 = time.perf_counter(), loop.rounds
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(plan["span_rounds"]):
                    loop.one()
                sync()
            spans.append(tr.read(prof, loop.rounds - r0))
            span_s.append(time.perf_counter() - ts)
            continue
        loop.one()
    window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    # the check, once the program's state is freed
    samples, launches, rounds = loop.samples(), entry.launches, loop.rounds
    loop.entry = loop.out = None
    del entry
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    chain = rchain.of(cfg)
    checks, failed = check(cfg, traffic, plan["limits"], chain, secrets, payloads, samples,
                           device)
    check_s = time.perf_counter() - t_check

    kept, dropped = tr.complete(spans, launches or {})
    traced_rounds = sum(s.rounds for s in spans)
    rec = types.SimpleNamespace(
        work=work.of(chain, cfg["clients"], len(payloads[0][0]), traffic["lazy"]),
        rounds=rounds, window_s=window_s, latency_ms=loop.latency_ms, setup_s=setup_s,
        spans=kept, mean_round_s=((window_s - sum(span_s)) / (rounds - traced_rounds)
                                  if rounds > traced_rounds else None))
    values = {}
    for name, unit, mod in metrics:
        v = mod.read(rec)
        if v is not None:
            values[name] = {"value": v, "unit": unit}
    result = {"correct": failed == 0, "attempted": rounds, "failed": failed, "metrics": values,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                         "count": 1, "memory_peak_bytes": peak}}
    steps = ", ".join(f"{name} {t - t_prev:.3f}"
                      for (name, t), (_, t_prev) in zip(marks, [("", t0)] + marks))
    notes = [f"rounds {rounds} in {window_s:.3f} s; set-up {setup_s:.3f} s ({steps}); checked "
             f"{len(samples)} rounds' outputs in {check_s:.3f} s"]
    if trace:
        notes.append(f"traced spans: {len(spans)} ({', '.join(f'{t:.2f}' for t in span_s)} s "
                     f"each), kept {len(kept)}, dropped {len(dropped)}"
                     + "".join(f"; dropped: {d}" for d in dropped))
        result["device"].update(busy_s=sum(s.busy_ns() for s in kept) / 1e9,
                                window_s=sum(s.window_ns for s in kept) / 1e9)
        result["breakdown"] = {
            "device_ops": tr.top((nm, e - b) for s in kept for nm, b, e in s.device),
            "idle_gaps": tr.top(g for s in kept for g in s.gaps())}
    result["checks"] = checks
    result["notes"] = notes
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin()
    root = Path.cwd()
    cache_dirs(root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell, cfg, traffic, plan = load(spec, args.workload, root)
    readers = metrics(spec, "per_layer" if args.trace else "end_to_end", cell["name"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {cell['name']} needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run(cell, cfg, traffic, plan, readers, args.seed, args.seconds, bool(args.trace),
                 "cuda")
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: the process loaded {loaded}", file=sys.stderr)
        return 3
    for note in result.pop("notes"):
        print(note, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
