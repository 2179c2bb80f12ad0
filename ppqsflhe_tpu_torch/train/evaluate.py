"""Per-round offline evaluation, without pandas.

Twin of ``ppqsflhe_tpu.train.evaluate`` (the reference's
c_evalulate_rounds.py: loads every round checkpoint (:104), computes
train/test metrics per round (:112-141), writes per-round prediction CSVs +
metric/prediction plots (:144-206)). It returns the metric rows as a list
of dicts (the JAX module returns a DataFrame) and writes the same CSVs:
``actual,predicted`` per round and one row per round with the columns in
first-seen order.
"""

from __future__ import annotations

import csv
import glob
import os
from datetime import datetime
from typing import Dict, List

import numpy as np

from . import data as D
from .trainer import MODEL_FAMILIES, calc_metrics, load_ckpt, load_ckpt_meta, predict


def _write_csv(path: str, rows: List[Dict]) -> None:
    fields: List[str] = []
    for row in rows:
        fields += [k for k in row if k not in fields]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)


def evaluate_rounds(cfg: Dict, out_dir: str | None = None, verbose: bool = True,
                    device="cuda") -> List[Dict]:
    """Evaluate every `<client>_best_*.npz` checkpoint in cfg['log_dir'] on
    the train and test splits; write metrics CSV + per-round predictions."""
    client_id = cfg.get("client_id", "client")
    lookback = int(cfg.get("lookback", 72))
    log_dir = cfg["log_dir"]
    out_dir = out_dir or os.path.join(os.path.dirname(log_dir), "results")
    os.makedirs(out_dir, exist_ok=True)
    ts = datetime.now().strftime("%Y%m%d_%H%M%S")

    df = D.load_timeseries(cfg["data_file"], dayfirst=bool(cfg.get("timestamp_dayfirst", True)))
    train_df, test_df = D.train_test_frames(df, cfg["train_end_date"], cfg["test_start_date"])
    fs = D.Scaler().fit(train_df[D.FEATURE_NAMES])
    tscl = D.Scaler().fit(train_df[[D.TARGET]])
    X_tr, y_tr = D.prepare_sequences(train_df, lookback, fs, tscl)
    X_te, y_te = D.prepare_sequences(test_df, lookback, fs, tscl)

    ckpts = sorted(glob.glob(os.path.join(log_dir, f"{client_id}_best_*.npz")))
    rows: List[Dict] = []
    for rnd, ck in enumerate(ckpts, start=1):
        params = load_ckpt(ck, device)
        # dispatch on the checkpoint's recorded family (fallback: cfg, then
        # gru for pre-tag checkpoints)
        mdl = MODEL_FAMILIES[load_ckpt_meta(ck) or cfg.get("model", "gru")]

        def run(X, y):
            if not len(X):
                return None, None, {}
            pred = tscl.inverse(predict(mdl, params, X, device).reshape(-1, 1)).flatten()
            truth = tscl.inverse(np.asarray(y).reshape(-1, 1)).flatten()
            return pred, truth, calc_metrics(truth, pred, truth.mean())

        _, _, m_tr = run(X_tr, y_tr)
        te_pred, te_truth, m_te = run(X_te, y_te)
        row = {"round": rnd, "checkpoint": os.path.basename(ck)}
        row.update({f"train_{k}": v for k, v in m_tr.items()})
        row.update({f"test_{k}": v for k, v in m_te.items()})
        rows.append(row)
        if te_pred is not None:
            _write_csv(os.path.join(out_dir, f"{client_id}_round{rnd}_predictions_{ts}.csv"),
                       [{"actual": a, "predicted": p} for a, p in zip(te_truth, te_pred)])
            # per-round actual-vs-predicted plot (c_evalulate_rounds.py:151-206)
            _plot_predictions(
                te_truth, te_pred, client_id, rnd,
                os.path.join(out_dir, f"{client_id}_round{rnd}_predictions_{ts}.png"))
        if verbose:
            print(f"[{client_id}] round {rnd}: {row}")

    _write_csv(os.path.join(out_dir, f"{client_id}_metrics_rounds_{ts}.csv"), rows)
    _plot_rounds(rows, client_id, os.path.join(out_dir, f"{client_id}_round_metrics_{ts}.png"))
    return rows


def _plot_predictions(truth, pred, client_id: str, rnd: int, path: str) -> None:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.plot(truth, label="actual", linewidth=1)
    ax.plot(pred, label="predicted", linewidth=1)
    ax.set_xlabel("test sample")
    ax.legend()
    ax.grid(True)
    ax.set_title(f"Test predictions - {client_id} round {rnd}")
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)


def _plot_rounds(rows: List[Dict], client_id: str, path: str) -> None:
    if not rows:
        return
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, ax = plt.subplots(figsize=(8, 4))
    for col in ("train_MAE", "test_MAE", "train_RMSE", "test_RMSE"):
        if col in rows[0]:
            ax.plot([r["round"] for r in rows], [r.get(col) for r in rows], marker="o",
                    label=col)
    ax.set_xlabel("round")
    ax.legend()
    ax.grid(True)
    ax.set_title(f"Metrics per round - {client_id}")
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)


def main(argv=None) -> int:
    """CLI twin of the reference's per-client evaluation script:

        python -m ppqsflhe_tpu_torch.train.evaluate [--device cpu|cuda] <client_config.json> [out_dir]

    The config is the CLIENT section (c_config.json schema) or any dict
    with data_file/log_dir/train_end_date/test_start_date."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description="per-round offline evaluation")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("config")
    ap.add_argument("out_dir", nargs="?")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    evaluate_rounds(cfg.get("CLIENT", cfg), out_dir=args.out_dir, device=args.device)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
