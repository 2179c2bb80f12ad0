"""The port's copy of the artifact exchange (``ppqsflhe_tpu_torch.comm``):
the JAX package's comm cases through it, the two packages' server and
client against each other, and the pandas-free analysis against the JAX
one."""

import csv
import os
import time
import urllib.error
import urllib.request

import pytest

from ppqsflhe_tpu.comm import analyze as janalyze
from ppqsflhe_tpu.comm.client import CommClient as JaxCommClient
from ppqsflhe_tpu.comm.server import ArtifactServer as JaxArtifactServer
from ppqsflhe_tpu_torch.comm import analyze
from ppqsflhe_tpu_torch.comm import client as port_client
from ppqsflhe_tpu_torch.comm.client import CommClient
from ppqsflhe_tpu_torch.comm.metrics import HEADER, MetricsLog
from ppqsflhe_tpu_torch.comm.server import ArtifactServer


@pytest.fixture(params=["port", "jax"])
def pair(request, tmp_path):
    """(server, storage root, tmp root, client class): the port's server
    with the port's client, and the port's server with the JAX client."""
    storage = str(tmp_path / "storage")
    os.makedirs(storage)
    with open(os.path.join(storage, "CC.json"), "w") as f:
        f.write('{"format": "test-cc"}')
    srv = ArtifactServer(storage, port=0,
                         metrics_csv=str(tmp_path / "server_metrics.csv")).start()
    yield srv, storage, str(tmp_path), CommClient if request.param == "port" else JaxCommClient
    srv.stop()


def test_get_cc_and_download(pair, tmp_path):
    srv, storage, root, Client = pair
    c = Client(f"http://127.0.0.1:{srv.port}", role="client_1",
               metrics_csv=os.path.join(root, "client_metrics.csv"))
    dest = str(tmp_path / "cc_local.json")
    c.get("/getCC", dest)
    assert open(dest).read() == '{"format": "test-cc"}'
    os.makedirs(os.path.join(storage, "client_1"), exist_ok=True)
    with open(os.path.join(storage, "client_1", "blob.bin"), "wb") as f:
        f.write(b"\x01\x02\x03" * 1000)
    dest2 = str(tmp_path / "blob.bin")
    c.get("/download/client_1/blob.bin", dest2)
    assert os.path.getsize(dest2) == 3000


def test_download_path_traversal_rejected(pair):
    srv, storage, root, _ = pair
    with open(os.path.join(root, "secret.txt"), "w") as f:
        f.write("credentials")
    for path in ("/download/../secret.txt", "/download/..%2Fsecret.txt",
                 "/download/client_1/../../secret.txt"):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}", timeout=10) as r:
                assert b"credentials" not in r.read(), path
        except urllib.error.HTTPError as e:
            assert e.code in (403, 404), (path, e.code)


def test_upload_multipart_and_metrics(pair, tmp_path):
    srv, storage, root, Client = pair
    mcsv = os.path.join(root, "client_metrics.csv")
    c = Client(f"http://127.0.0.1:{srv.port}", role="client_2", metrics_csv=mcsv)
    payload = str(tmp_path / "enc_weights.json")
    with open(payload, "w") as f:
        f.write('{"weights_summary": []}')
    c.post_file("/uploadEncWeightsC2", payload, client_id="client_2", type_="enc_weights")
    stored = os.path.join(storage, "client_2", "enc_weights.json")
    assert open(stored).read() == '{"weights_summary": []}'
    with open(mcsv) as f:
        rows = list(csv.reader(f))
    assert rows[0] == HEADER and rows[-1][1] == "client_2"
    # the server writes its row after it has answered
    for _ in range(100):
        with open(os.path.join(root, "server_metrics.csv")) as f:
            posts = [r for r in csv.DictReader(f) if r["method"] == "POST"]
        if posts:
            break
        time.sleep(0.05)
    up = posts[-1]
    assert (up["endpoint"], up["client_id"], up["type"], up["file"], up["payload_size"]) == (
        "/uploadEncWeightsC2", "client_2", "enc_weights", "enc_weights.json", "23")


def test_pubkey_route(pair, tmp_path):
    srv, storage, root, Client = pair
    c = Client(f"http://127.0.0.1:{srv.port}")
    pk = str(tmp_path / "client_1-public.key")
    with open(pk, "w") as f:
        f.write("PUBKEY1")
    c.post_file("/uploadPubKeyC1", pk, client_id="client_1", type_="pubkey")
    dest = str(tmp_path / "fetched.key")
    c.get("/sendPbKeyC1", dest)
    assert open(dest).read() == "PUBKEY1"


def test_port_client_against_jax_server(tmp_path):
    """The reverse pairing: the JAX server stores what the port's client
    uploads and serves it back."""
    storage = str(tmp_path / "storage")
    srv = JaxArtifactServer(storage, port=0).start()
    try:
        c = CommClient(f"http://127.0.0.1:{srv.port}", role="client_3")
        up = str(tmp_path / "agg.bin")
        with open(up, "wb") as f:
            f.write(bytes(range(256)) * 64)
        c.post_file("/uploadAggregated", up, client_id="server", type_="aggregated")
        c.get("/download/agg.bin", str(tmp_path / "back.bin"))
        assert open(tmp_path / "back.bin", "rb").read() == bytes(range(256)) * 64
    finally:
        srv.stop()


def test_local_mode(tmp_path):
    """COMM_MODE != MONGOOSE cp fallback (comm_fns.sh:14-18)."""
    storage = str(tmp_path / "srv")
    os.makedirs(storage)
    with open(os.path.join(storage, "CC.json"), "w") as f:
        f.write("CC")
    c = CommClient(mode="local", local_storage_root=storage)
    dest = str(tmp_path / "cc.json")
    c.get("/getCC", dest)
    assert open(dest).read() == "CC"
    up = str(tmp_path / "w.json")
    with open(up, "w") as f:
        f.write("W")
    c.post_file("/uploadEncWeightsC1", up)
    assert open(os.path.join(storage, "client_1", "w.json")).read() == "W"


def test_get_retries_then_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(port_client, "BACKOFF_S", 0.01)
    c = CommClient("http://127.0.0.1:9", role="x")  # closed port
    with pytest.raises(ConnectionError):
        c.get("/getCC", str(tmp_path / "nope"))


def make_csvs(tmp):
    """tests/test_analysis.py's metrics pair (one size mismatch), written by
    the port's MetricsLog."""
    c = MetricsLog(str(tmp / "client.csv"), "client")
    s = MetricsLog(str(tmp / "server.csv"), "server")
    c.log("POST", "/uploadEncWeightsC1", "client_1", "enc_weights", "w.json",
          payload_size=1000, bytes_sent=1000, latency_ms=12)
    s.log("POST", "/uploadEncWeightsC1", "client_1", "enc_weights", "w.json",
          payload_size=1000, bytes_received=1000, latency_ms=3)
    c.log("GET", "/getCC", "", "cc", "CC.json", bytes_received=500, latency_ms=5)
    c.log("POST", "/uploadReKeyC2", "client_2", "rekey", "rk.key",
          payload_size=5000, bytes_sent=5000, latency_ms=9)
    s.log("POST", "/uploadReKeyC2", "client_2", "rekey", "rk.key",
          payload_size=3000, bytes_received=3000, latency_ms=2)
    c.log("GET", "/download", "client_1", "aggregated", "agg.json", bytes_received=700,
          latency_ms=7.5)
    return str(tmp / "client.csv"), str(tmp / "server.csv")


def test_analysis_matches_jax(tmp_path):
    """Summaries (per type, sorted) and the cross-check equal the JAX
    module's on CSVs whose rows all carry a type."""
    ccsv, scsv = make_csvs(tmp_path)
    got = analyze.analyze(ccsv, scsv)
    want = janalyze.analyze(ccsv, scsv)
    assert got == want
    assert got["cross_check"]["size_mismatches"][0]["file"] == "rk.key"


def test_analysis_infers_missing_types(tmp_path):
    """A row without a type gets the reference's inferred one (the JAX
    module labels it "nan"); plots are skipped or written, never raised."""
    log = MetricsLog(str(tmp_path / "c.csv"), "client")
    for ep in ("/getCC", "/uploadPubKeyC1", "/uploadReKeyC1", "/uploadEncWeightsC1",
               "/download/c2_domainChange_c1.json", "/healthz"):
        log.log("GET", ep, latency_ms=1.0)
    rows = analyze.load_metrics(str(tmp_path / "c.csv"))
    assert [r["type"] for r in rows] == ["cc", "pubkey", "rekey", "enc_weights", "aggregated",
                                         "other"]
    assert {r["type"] for r in janalyze.load_metrics(str(tmp_path / "c.csv")).to_dict("records")} \
        == {"nan"}
    res = analyze.analyze(str(tmp_path / "c.csv"), plot_dir=str(tmp_path / "plots"))
    assert [r["calls"] for r in res["client_summary"]] == [1, 1, 1, 1, 1, 1]
    assert len(res["plots"]) in (0, 3)
