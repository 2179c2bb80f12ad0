"""Readings for the limits of a cell's check: its run, in one process, on
many seeds, with the configuration as stated or with its control.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 --seconds 3 [--control]

``--control`` runs the program on the configuration's ``control`` chain
(``scaling_mod_size`` as the configuration's ``control`` states: scaling
primes that fit 32-bit words), which the check has to fail. Each seed is one
:func:`benchmark.run.run` at the cell's own sizes (set-up, a window of
``--seconds``, the check of a sample of rounds); one JSON line a seed with
the numbers compared, then one with the largest of each over the seeds."""

from __future__ import annotations

import argparse
import gc
import json
import time
from pathlib import Path

from benchmark import run


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    root = Path.cwd()
    run.cache_dirs(root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell, cfg, traffic, plan = run.load(spec, args.workload, root)
    if args.control:
        cfg["scaling_mod_size"] = cfg["control"]["scaling_mod_size"]
    worst = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run(cell, cfg, traffic, plan, [], seed, args.seconds, False, "cuda",
                      t0=time.perf_counter())
        nums = {k: c["value"] for k, c in res["checks"].items()}
        worst = {k: max(worst.get(k, v), v) for k, v in nums.items()}
        print(json.dumps({"seed": seed, "control": args.control, "correct": res["correct"],
                          "rounds": res["attempted"], **nums}), flush=True)
        del res
        gc.collect()
    print(json.dumps({"workload": args.workload, "control": args.control,
                      "scaling_mod_size": cfg["scaling_mod_size"], "worst": worst}), flush=True)


if __name__ == "__main__":
    main()
