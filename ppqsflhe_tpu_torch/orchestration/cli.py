"""Orchestrator CLI — the run.sh entry point equivalent, on the port.

  python -m ppqsflhe_tpu_torch.orchestration.cli <oConfig.json> [--resume] [--device cpu|cuda]

Twin of ``ppqsflhe_tpu.orchestration.cli``, reading the same schema; every
tool and the trainer run on ``--device`` (default: the card).

Config schema (superset of the reference orchestration/oConfig.json):
{
  "ROUNDS": 5, "N_CLIENTS": 2, "WORK_DIR": "./fl_run",
  "COMM_MODE": "MONGOOSE" | "local",      # MONGOOSE → http (reference name)
  "SERVER_IP": "127.0.0.1", "SERVER_PORT": 8080,
  "CC_CONFIG": { ...config_cc.json schema... },
  "CLIENT_CONFIGS": [ { ...CLIENT section... }, ... ],
  "TRAIN": true
}
"""

from __future__ import annotations

import argparse
import json
import sys

from .orchestrator import Orchestrator, OrchestratorConfig


def config(cfg: dict, device="cuda") -> OrchestratorConfig:
    """The orchestrator's configuration from an oConfig document."""
    mode = cfg.get("COMM_MODE", "local")
    return OrchestratorConfig(
        rounds=int(cfg.get("ROUNDS", 5)),
        n_clients=int(cfg.get("N_CLIENTS", 2)),
        work_dir=cfg.get("WORK_DIR", "./fl_run"),
        comm_mode="http" if mode.upper() == "MONGOOSE" else mode,
        host=cfg.get("SERVER_IP", "127.0.0.1"),
        port=int(cfg.get("SERVER_PORT", 0)),
        cc_config=cfg.get("CC_CONFIG", {}),
        client_configs=cfg.get("CLIENT_CONFIGS", []),
        train=bool(cfg.get("TRAIN", True)),
        seed=int(cfg.get("SEED", 1234)),
        protocol=cfg.get("PROTOCOL", "pre"),
        lazy_levels=bool(cfg.get("LAZY_LEVELS", False)),
        fail_fast=bool(cfg.get("FAIL_FAST", False)),
        min_clients=int(cfg.get("MIN_CLIENTS", 1)),
        device=device,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="FL rounds orchestrator")
    ap.add_argument("config", nargs="?")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.config:
        print(__doc__)
        return 2
    with open(args.config) as f:
        cfg = json.load(f)
    results = Orchestrator(config(cfg, args.device)).run(resume=args.resume)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
