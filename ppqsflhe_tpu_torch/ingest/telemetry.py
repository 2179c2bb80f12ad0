"""Telemetry producers/consumers for the FL workload.

The reference's documented flow (README.md:36: "telemetry is streamed via
Kafka producers and consumed into client-local storage", :74 "topics
configured per client") ends in the per-client training CSVs that
``c_trainAndUpdate.py`` reads. Here:

- :class:`TelemetryProducer` publishes ``{"Timestamp": ..., "Data": ...}``
  records to a per-client topic (over a local Broker or HttpBrokerClient);
- :class:`CsvMaterializer` is the client-side consumer: it drains its topic
  (consumer-group positioned, so restarts resume) and appends to the
  client-local CSV in exactly the schema ``train.data.load_timeseries``
  consumes;
- :func:`replay_csv` streams an existing telemetry CSV through a producer
  (the reference's "Kafka producer" role for recorded data).
"""

from __future__ import annotations

import csv
import os
from typing import Any, Dict, Iterable, List

TIMESTAMP = "Timestamp"
TARGET = "Data"


def topic_for_client(client_id: str) -> str:
    """Per-client topic naming (README.md:74 'topics configured per client')."""
    return f"telemetry.{client_id}"


class TelemetryProducer:
    """Publishes telemetry records to a client's topic.

    ``broker`` is anything with Broker's producer surface (Broker or
    service.HttpBrokerClient)."""

    def __init__(self, broker, client_id: str):
        self.broker = broker
        self.topic = topic_for_client(client_id)

    def send(self, timestamp: str, value: float, **extra: Any) -> int:
        rec = {TIMESTAMP: timestamp, TARGET: float(value), **extra}
        return self.broker.publish(self.topic, rec)

    def send_batch(self, records: Iterable[Dict[str, Any]]) -> List[int]:
        recs = []
        for r in records:
            if TIMESTAMP not in r or TARGET not in r:
                raise ValueError(f"telemetry record needs {TIMESTAMP!r} and "
                                 f"{TARGET!r}: {r}")
            recs.append({**r, TARGET: float(r[TARGET])})
        return self.broker.publish_batch(self.topic, recs)


def replay_csv(broker, client_id: str, csv_path: str,
               batch_size: int = 1000) -> int:
    """Stream an existing telemetry CSV into the client's topic; returns the
    record count. Columns beyond Timestamp/Data ride along unchanged."""
    prod = TelemetryProducer(broker, client_id)
    n = 0
    with open(csv_path, newline="") as f:
        batch: List[Dict[str, Any]] = []
        for row in csv.DictReader(f):
            batch.append(dict(row))
            if len(batch) >= batch_size:
                n += len(prod.send_batch(batch))
                batch = []
        if batch:
            n += len(prod.send_batch(batch))
    return n


class CsvMaterializer:
    """Client-side consumer: drain the client's telemetry topic into the
    local training CSV (the 'consumed into client-local storage' half of the
    reference's pipeline). Offset tracking is per consumer-group, so a
    restarted client appends only records it has not yet materialized."""

    def __init__(self, broker, client_id: str, csv_path: str,
                 group: str = "csv_materializer"):
        self.broker = broker
        self.client_id = client_id
        self.topic = topic_for_client(client_id)
        self.csv_path = csv_path
        self.group = group

    def drain(self, max_records: int | None = None) -> int:
        """Consume everything currently in the topic (or up to max_records);
        returns how many rows were appended."""
        recs = self.broker.poll(self.topic, self.group, max_records)
        if not recs:
            return 0
        rows = [r["value"] for r in recs]
        fields = [TIMESTAMP, TARGET] + sorted(
            {k for row in rows for k in row} - {TIMESTAMP, TARGET})
        exists = os.path.exists(self.csv_path) and os.path.getsize(self.csv_path) > 0
        os.makedirs(os.path.dirname(self.csv_path) or ".", exist_ok=True)
        with open(self.csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields, extrasaction="ignore")
            if not exists:
                w.writeheader()
            for row in rows:
                w.writerow(row)
        return len(rows)
