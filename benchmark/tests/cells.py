"""Small copies of the benchmark's cells for CPU tests: the stated
configuration at a small ring (or at its own ring with few ciphertexts),
run by :func:`benchmark.run.run` through the program's eager round, since a
CUDA graph is captured only on the card."""

from __future__ import annotations

import json
import time
import warnings
from pathlib import Path

from benchmark import run
from benchmark.entries import multikey, pairwise

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
ENTRIES = {"pairwise": pairwise, "multikey": multikey}
SMALL = {"vectors": {"count": 3}, "layers": {"shapes": [[3, 100], [40]]}}


def load(cell_name: str, ring: int = 256, payload: dict | None = None):
    """(cell, config, traffic, plan) with the ring cut to ``ring`` (slots
    N/2) and a small payload."""
    cell, cfg, traffic, plan = run.load(SPEC, cell_name, ROOT)
    cfg.update(ring_dim=ring, batch_size=ring // 2)
    traffic["payload"].update(payload or SMALL[traffic["payload"]["kind"]])
    return cell, cfg, traffic, plan


def drive(monkeypatch, cell, cfg, traffic, plan, wrap=lambda entry, rnd: rnd, seed=2**31 + 7):
    """One run on the CPU with the eager round, wrapped by ``wrap(entry,
    round)`` → the result."""
    mod = ENTRIES[cfg["entry"]]

    def start(entry):
        entry.round = wrap(entry, entry.eager())
        entry.launches = None

    monkeypatch.setattr(mod.Entry, "start", start)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return run.run(cell, cfg, traffic, plan, [], seed, 0.05, False, "cpu",
                       t0=time.perf_counter())
