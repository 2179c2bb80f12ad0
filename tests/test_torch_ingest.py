"""The port's copy of the telemetry ingestion pipeline
(``ppqsflhe_tpu_torch.ingest``): the JAX package's ingest cases through it,
its broker files read by the JAX broker, and the port's trainer draining a
topic before it trains."""

import csv
import os

import numpy as np
import pytest

from ppqsflhe_tpu.ingest import Broker as JaxBroker
from ppqsflhe_tpu_torch.ingest import Broker, CsvMaterializer, IngestServer, \
    TelemetryProducer, replay_csv
from ppqsflhe_tpu_torch.ingest.service import HttpBrokerClient


def test_publish_fetch_offsets(tmp_path):
    b = Broker(str(tmp_path))
    assert b.topics() == []
    assert [b.publish("t1", {"x": i}) for i in range(5)] == list(range(5))
    assert b.end_offset("t1") == 5 and b.topics() == ["t1"]
    recs = b.fetch("t1", offset=2)
    assert [r["value"]["x"] for r in recs] == [2, 3, 4]
    assert [r["offset"] for r in recs] == [2, 3, 4]
    assert b.fetch("t1", offset=2, max_records=1)[0]["value"]["x"] == 2
    assert b.fetch("t1", offset=99) == [] and b.fetch("nope") == []


def test_publish_batch_and_key(tmp_path):
    b = Broker(str(tmp_path))
    assert b.publish_batch("t", [1, 2, 3], key="k1") == [0, 1, 2]
    assert all(r["key"] == "k1" for r in b.fetch("t"))


def test_consumer_groups_resume_independently(tmp_path):
    b = Broker(str(tmp_path))
    b.publish_batch("t", list(range(10)))
    assert [r["value"] for r in b.poll("t", "A", max_records=4)] == [0, 1, 2, 3]
    assert [r["value"] for r in b.poll("t", "B")] == list(range(10))
    b2 = Broker(str(tmp_path))
    assert b2.committed("t", "A") == 4
    assert [r["value"] for r in b2.poll("t", "A")] == [4, 5, 6, 7, 8, 9]
    assert b2.poll("t", "A") == [] and b2.poll("t", "B") == []


def test_broker_files_shared_with_jax(tmp_path):
    """Both packages' brokers on one root: the same logs and offsets."""
    b, jb = Broker(str(tmp_path)), JaxBroker(str(tmp_path))
    b.publish_batch("t", ["a", "b"])
    jb.publish("t", "c")
    assert [r["value"] for r in jb.fetch("t")] == ["a", "b", "c"]
    assert [r["value"] for r in b.poll("t", "g", max_records=2)] == ["a", "b"]
    assert jb.committed("t", "g") == 2 and [r["value"] for r in jb.poll("t", "g")] == ["c"]


def test_invalid_names(tmp_path):
    b = Broker(str(tmp_path))
    with pytest.raises(ValueError):
        b.publish("../evil", 1)
    with pytest.raises(ValueError):
        b.commit("t", "gr/oup", 0)


def test_http_service_roundtrip(tmp_path):
    srv = IngestServer(str(tmp_path), port=0).start()
    try:
        c = HttpBrokerClient(f"http://127.0.0.1:{srv.port}")
        assert c.publish("metrics", {"v": 1.5}) == 0
        assert c.publish_batch("metrics", [{"v": 2.0}, {"v": 3.0}]) == [1, 2]
        assert c.end_offset("metrics") == 3 and c.topics() == ["metrics"]
        assert [r["value"]["v"] for r in c.fetch("metrics", offset=1)] == [2.0, 3.0]
        assert [r["value"]["v"] for r in c.poll("metrics", "g1", max_records=2)] == [1.5, 2.0]
        assert c.committed("metrics", "g1") == 2
        c.commit("metrics", "g1", 0)
        assert c.committed("metrics", "g1") == 0
    finally:
        srv.stop()


def _rows(n, fmt="%Y-%m-%d %H:%M:%S", seed=0):
    ts = np.datetime64("2024-01-01T00:00") + np.arange(n).astype("timedelta64[h]")
    rng = np.random.default_rng(seed)
    return [{"Timestamp": t.strftime(fmt), "Data": float(v)}
            for t, v in zip(ts.astype(object), rng.uniform(10, 20, n))]


def test_telemetry_to_training_csv(tmp_path):
    """Produce → CsvMaterializer drains into the client-local CSV → the
    port's load_timeseries reads it."""
    from ppqsflhe_tpu_torch.train.data import FEATURE_NAMES, load_timeseries

    b = Broker(str(tmp_path / "broker"))
    prod = TelemetryProducer(b, "client_1")
    rows = _rows(50)
    prod.send_batch(rows[:30])
    csv_path = str(tmp_path / "client_1" / "training_data.csv")
    mat = CsvMaterializer(b, "client_1", csv_path)
    assert mat.drain() == 30
    prod.send_batch(rows[30:])
    assert mat.drain() == 20 and mat.drain() == 0
    df = load_timeseries(csv_path)
    assert len(df) == 50 and all(c in df for c in FEATURE_NAMES)
    np.testing.assert_allclose(df["Data"], [r["Data"] for r in rows], rtol=1e-12)
    assert df["HourOfDay"].tolist() == [i % 24 for i in range(50)]


def test_trainer_telemetry_hook(tmp_path):
    """train_client with telemetry_broker_root drains the client's topic into
    data_file before reading it — training runs purely off streamed data."""
    from ppqsflhe_tpu_torch.train.trainer import train_client

    b = Broker(str(tmp_path / "broker"))
    ts = np.datetime64("2024-07-01T00:00") + np.arange(200).astype("timedelta64[h]")
    rng = np.random.default_rng(3)
    vals = 100 + 20 * np.sin(2 * np.pi * (np.arange(200) % 24) / 24) + rng.normal(0, 2, 200)
    TelemetryProducer(b, "t1").send_batch(
        [{"Timestamp": t.strftime("%d-%m-%Y %H:%M"), "Data": float(v)}
         for t, v in zip(ts.astype(object), vals)])
    csv_path = str(tmp_path / "stream.csv")
    cfg = {
        "client_id": "t1", "data_file": csv_path,
        "telemetry_broker_root": str(tmp_path / "broker"),
        "train_end_date": "2024-07-07 23:00:00", "test_start_date": "2024-07-08 00:00:00",
        "lookback": 24, "n_features": 6, "epochs": 2, "hidden": 8,
        "INPUT_WEIGHTS_PATH": str(tmp_path / "weights.json"),
        "OUTPUT_DECRYPTED_WEIGHTS_PATH": str(tmp_path / "decrypted.json"),
    }
    res = train_client(cfg, seed=0, verbose=False, device="cpu")
    assert os.path.exists(csv_path) and len(res.history["loss"]) == 2
    assert os.path.exists(cfg["INPUT_WEIGHTS_PATH"])


def test_replay_csv_roundtrip(tmp_path):
    src = str(tmp_path / "src.csv")
    rows = _rows(25)
    with open(src, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["Timestamp", "Data"])
        w.writeheader()
        w.writerows(rows)
    b = Broker(str(tmp_path / "broker"))
    assert replay_csv(b, "client_2", src, batch_size=10) == 25
    out = str(tmp_path / "out.csv")
    assert CsvMaterializer(b, "client_2", out).drain() == 25
    with open(out) as f:
        got = list(csv.DictReader(f))
    assert len(got) == 25 and got[0]["Timestamp"] == rows[0]["Timestamp"]
    np.testing.assert_allclose([float(r["Data"]) for r in got], [r["Data"] for r in rows],
                               rtol=1e-12)
