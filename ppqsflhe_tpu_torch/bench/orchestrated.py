"""Per-step breakdown of the orchestrated end-to-end round on one GPU: the
twin of ``bench_orchestrated.py`` (``:28-116``).

Runs a full 2-round orchestrated FL run at the reference shape (the
reference N=2^14 chain, 2 clients over http, INDCPA, lazy levels, the PQWD
binary wire, ``train=False``) with the JAX bench's numpy payload (one layer
of 39,041 values from ``default_rng(i)`` for client i: 7 ciphertexts at
8192 slots), on the card, and reports where the warm round's wall-clock goes, parsed
from the orchestrator's ms-resolution step log. Round 1 builds the
context's tables and the kernels; round 2 is the warm number::

    python -m ppqsflhe_tpu_torch.bench.orchestrated

It prints one JSON line with the JAX bench's keys
(``"metric": "orchestrated_round_s_warm"``, ``total_run_s``, the per-step
``rounds`` tables) plus ``"card"``, and refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import tempfile
import time
from datetime import datetime

import numpy as np
import torch

from ..orchestration import Orchestrator, OrchestratorConfig
from .multikey import card_line

N_VALUES = 39041     # the GRU export's parameter count
_LINE = re.compile(r"^\[(\d{4}-\d\d-\d\dT[\d:.]+)\] \[([^\]]+)\] \[([^\]]+)\] ?(.*)$")
_ROUND = re.compile(r"round (\d+) complete")


def write_payload(path: str, seed: int) -> None:
    """bench_orchestrated.py's fallback payload: one layer of 39,041
    normal(0, 0.2) values from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        json.dump({"weights_summary": [{
            "layer": "d", "shape": [N_VALUES], "mean": 0.0, "std_dev": 1.0,
            "values": rng.normal(0, 0.2, N_VALUES).tolist()}]}, f)


def config(work: str, device) -> OrchestratorConfig:
    """The JAX bench's configuration, its payloads written under ``work``."""
    w_paths = []
    for i in (1, 2):
        w_paths.append(os.path.join(work, f"w{i}.json"))
        write_payload(w_paths[-1], i)
    return OrchestratorConfig(
        rounds=2, n_clients=2, work_dir=os.path.join(work, "run"), comm_mode="http",
        cc_config={"multiplicative_depth": 2, "scaling_mod_size": 40, "batch_size": 8192,
                   "PREMode": "INDCPA", "use_reference_chain": True},
        client_configs=[{"INPUT_WEIGHTS_PATH": w} for w in w_paths],
        train=False, seed=11, lazy_levels=True, binary_wire=True, device=str(device))


def run(cfg: OrchestratorConfig, resume: bool = False):
    """Drive ``cfg`` (``resume``: from its work dir's checkpoint); its step
    log goes to stderr and is returned. Returns (the rounds' results, the
    log, total seconds)."""
    buf = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, s):
            buf.write(s)
            sys.stderr.write(s)
            return len(s)

        def flush(self):
            sys.stderr.flush()

    t0 = time.time()
    with contextlib.redirect_stdout(Tee()):
        results = Orchestrator(cfg).run(resume=resume)
    return results, buf.getvalue(), time.time() - t0


def step_tables(log: str) -> list:
    """Per-step durations per round from the step log: a line marks a
    step's start, so a step lasts until the next line; ``[orchestrator]
    [round]`` lines mark a round's completion (and give its number), and a
    round's steps start after the init (or resume) line."""
    events = []
    for line in log.splitlines():
        m = _LINE.match(line)
        if m:
            events.append((datetime.fromisoformat(m.group(1)).timestamp(), m.group(2),
                           m.group(3), m.group(4)))
    bounds = [i for i, e in enumerate(events) if e[2] == "round"]
    tables = []
    prev = max((i for i, e in enumerate(events[: bounds[0] if bounds else 0])
                if e[2] in ("init", "resume")), default=-1)
    for ri, b in enumerate(bounds):
        seg = events[prev + 1 : b + 1]
        prev = b
        rows = [{"step": f"{e[1]}:{e[2]}", "ms": round((e2[0] - e[0]) * 1e3, 1)}
                for e, e2 in zip(seg, seg[1:])]
        m = _ROUND.search(events[b][3])
        tables.append({"round": int(m.group(1)) if m else ri + 1,
                       "total_s": round(seg[-1][0] - seg[0][0], 2), "steps": rows})
    return tables


def summary(log: str, total_s: float) -> dict:
    tables = step_tables(log)
    warm = tables[-1] if tables else {}
    return {"metric": "orchestrated_round_s_warm", "value": warm.get("total_s"), "unit": "s",
            "total_run_s": round(total_s, 1), "rounds": tables}


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench.orchestrated: torch.cuda.is_available() is False — needs a "
                         "CUDA GPU")
    card = card_line()
    with tempfile.TemporaryDirectory(prefix="bench_orch_") as work:
        _, log, total = run(config(work, "cuda"))
    print(json.dumps(dict(summary(log, total), card=card)))


if __name__ == "__main__":
    main()
