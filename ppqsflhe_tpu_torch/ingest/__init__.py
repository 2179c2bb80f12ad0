"""Telemetry ingestion pipeline — the reference README's claimed Kafka layer,
implemented natively. The port's stdlib copy of ``ppqsflhe_tpu.ingest``
(the trainer's telemetry hook drains it); it imports no framework.

The reference documents a "Kafka-based Ingestion Pipeline: streams telemetry
data securely into client-local storage" with per-client topics
(README.md:16,28,36,74) but ships NO ingestion code (SURVEY.md §5.8: "no
kafka reference in any script"). This package supplies that capability
without an external broker dependency:

- :mod:`broker` — durable append-only topic logs with offsets and
  consumer-group commits (the Kafka storage model, file-backed);
- :mod:`service` — an HTTP pub/sub facade for multi-host deployments
  (producers on telemetry hosts, consumers on FL clients);
- :mod:`telemetry` — producers/consumers for the FL workload: stream
  telemetry records into per-client topics and materialize them as the
  client-local training CSVs `train.data.load_timeseries` consumes.
"""

from .broker import Broker
from .service import IngestServer
from .telemetry import CsvMaterializer, TelemetryProducer, replay_csv

__all__ = ["Broker", "IngestServer", "TelemetryProducer", "CsvMaterializer",
           "replay_csv"]
