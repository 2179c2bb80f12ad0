"""Offline communication-metrics analysis, without pandas.

Twin of ``ppqsflhe_tpu.comm.analyze`` (the reference's
orchestration/metrics/analyze_comm_metrics.py: :65-115 load, :120-181
client↔server cross-check, :186-249 summaries, :264-316 plots): loads the
client and server CSVs, type-infers rows, cross-checks matching
endpoint+file within a time window flagging size mismatches, and emits
summaries + optional PNG plots. Rows are plain dicts and a summary is a
list of dicts (one per type, sorted by type), where the JAX module returns
DataFrames.

One difference: a row whose ``type`` field is empty gets the inferred type.
The JAX module reads the empty field as NaN, which is truthy, and labels
such rows ``"nan"`` instead of running the inference.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from datetime import datetime
from typing import Dict, List

MATCH_WINDOW_S = 60          # reference: 60 s pairing window (:139)
SIZE_TOLERANCE = 0.01        # reference: 1% size tolerance (:160)
NUMERIC = ("payload_size", "bytes_sent", "bytes_received", "latency_ms")
_TYPE_KEYS = (("PubKey", "pubkey"), ("ReKey", "rekey"), ("EncWeights", "enc_weights"),
              ("getCC", "cc"), ("aggregated", "aggregated"), ("domainChange", "aggregated"))


def _number(text):
    """int, else float, else 0 (pandas' to_numeric(errors="coerce").fillna(0))."""
    for kind in (int, float):
        try:
            v = kind(text)
        except (TypeError, ValueError):
            continue
        return 0 if v != v else v
    return 0


def _timestamp(text):
    try:
        return datetime.fromisoformat(str(text))
    except ValueError:
        return None


def _infer_type(row: Dict) -> str:
    """The reference's heuristics (:98-112) for rows without a type."""
    t = row.get("type") or ""
    if t and t != "-":
        return t
    e = str(row.get("endpoint", ""))
    return next((name for key, name in _TYPE_KEYS if key in e), "other")


def load_metrics(path: str) -> List[Dict]:
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    for row in rows:
        row["timestamp"] = _timestamp(row.get("timestamp"))
        for col in NUMERIC:
            row[col] = _number(row.get(col))
        row["type"] = _infer_type(row)
    return rows


@dataclass
class CrossCheckResult:
    matched: int = 0
    unmatched_client: int = 0
    size_mismatches: List[Dict] = field(default_factory=list)


def cross_check(client_rows: List[Dict], server_rows: List[Dict]) -> CrossCheckResult:
    """Pair client rows with server rows on endpoint+basename within the
    window; flag payload size disagreements (> tolerance)."""
    res = CrossCheckResult()
    for row in client_rows:
        base = os.path.basename(str(row["file"]))
        cand = [s for s in server_rows
                if s["endpoint"] == row["endpoint"] and os.path.basename(str(s["file"])) == base]
        if cand and row["timestamp"] is not None:
            cand = [s for s in cand if s["timestamp"] is not None
                    and abs((s["timestamp"] - row["timestamp"]).total_seconds())
                    <= MATCH_WINDOW_S]
        if not cand:
            res.unmatched_client += 1
            continue
        res.matched += 1
        srow = cand[0]
        c_size = max(row["payload_size"], row["bytes_received"])
        s_size = max(srow["payload_size"], srow["bytes_received"], srow["bytes_sent"])
        if c_size and s_size:
            rel = abs(c_size - s_size) / max(c_size, s_size)
            if rel > SIZE_TOLERANCE:
                res.size_mismatches.append({
                    "endpoint": row["endpoint"], "file": base,
                    "client_size": int(c_size), "server_size": int(s_size),
                })
    return res


def summarize(rows: List[Dict]) -> List[Dict]:
    """Per-type totals: calls, bytes, latency stats (reference :186-249)."""
    out = []
    for t in sorted({r["type"] for r in rows}):
        g = [r for r in rows if r["type"] == t]
        lat = [r["latency_ms"] for r in g]
        out.append({
            "type": t, "calls": len(g),
            "bytes_sent": sum(r["bytes_sent"] for r in g),
            "bytes_received": sum(r["bytes_received"] for r in g),
            "payload_total": sum(r["payload_size"] for r in g),
            "latency_ms_mean": sum(lat) / len(lat),
            "latency_ms_max": max(lat),
        })
    return out


def plot_metrics(rows: List[Dict], out_dir: str) -> List[str]:
    """The reference's 3 plots: bytes by type, per-call payloads, latency
    histogram (:264-316). Silently skips without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return []
    os.makedirs(out_dir, exist_ok=True)
    out = []

    s = summarize(rows)
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.bar([r["type"] for r in s], [r["payload_total"] / 1e6 for r in s])
    ax.set_ylabel("payload MB")
    ax.set_title("Bytes by artifact type")
    p = os.path.join(out_dir, "bytes_by_type.png")
    fig.savefig(p, dpi=100, bbox_inches="tight")
    plt.close(fig)
    out.append(p)

    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot([r["payload_size"] / 1e6 for r in rows], marker="o", ms=3, lw=0.5)
    ax.set_ylabel("payload MB")
    ax.set_xlabel("call #")
    ax.set_title("Per-call payloads")
    p = os.path.join(out_dir, "per_call_payloads.png")
    fig.savefig(p, dpi=100, bbox_inches="tight")
    plt.close(fig)
    out.append(p)

    fig, ax = plt.subplots(figsize=(8, 4))
    ax.hist([r["latency_ms"] for r in rows], bins=30)
    ax.set_xlabel("latency ms")
    ax.set_title("Latency distribution")
    p = os.path.join(out_dir, "latency_hist.png")
    fig.savefig(p, dpi=100, bbox_inches="tight")
    plt.close(fig)
    out.append(p)
    return out


def analyze(client_csv: str, server_csv: str | None = None,
            plot_dir: str | None = None) -> Dict:
    crows = load_metrics(client_csv)
    result = {"client_summary": summarize(crows)}
    if server_csv and os.path.exists(server_csv):
        srows = load_metrics(server_csv)
        result["server_summary"] = summarize(srows)
        cc = cross_check(crows, srows)
        result["cross_check"] = {
            "matched": cc.matched,
            "unmatched_client": cc.unmatched_client,
            "size_mismatches": cc.size_mismatches,
        }
    if plot_dir:
        result["plots"] = plot_metrics(crows, plot_dir)
    return result
