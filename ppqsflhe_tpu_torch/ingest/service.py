"""HTTP pub/sub facade over :class:`~ppqsflhe_tpu_torch.ingest.broker.Broker` —
the multi-host shape of the reference's claimed Kafka broker (README.md:48:
"Kafka Broker: handles publish/subscribe ingestion pipeline").

Endpoints (JSON in/out):

  POST /topics/<t>/publish           body {"value": ..., "key"?: str} or
                                     {"values": [...]} → {"offsets": [...]}
  GET  /topics/<t>/fetch?offset=&max=        → {"records": [...]}
  GET  /topics/<t>/poll?group=&max=          → {"records": [...]} (commits)
  POST /topics/<t>/commit            body {"group": str, "offset": int}
  GET  /topics/<t>/offsets?group=            → {"end": int, "committed": int}
  GET  /topics                               → {"topics": [...]}
  GET  /healthz

Same stdlib ThreadingHTTPServer pattern as comm.server.ArtifactServer; the
transport is deliberately boring — telemetry ingestion is control-plane.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .broker import Broker


class _Handler(BaseHTTPRequestHandler):
    server_version = "ppqsflhe-ingest/0.1"

    def log_message(self, fmt, *args):
        pass

    @property
    def broker(self) -> Broker:
        return self.server.broker  # type: ignore[attr-defined]

    def _json(self, obj, code: int = 200) -> None:
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        u = urlparse(self.path)
        q = {k: v[0] for k, v in parse_qs(u.query).items()}
        if u.path == "/healthz":
            self._json({"ok": True})
            return
        if u.path == "/topics":
            self._json({"topics": self.broker.topics()})
            return
        m = re.fullmatch(r"/topics/([\w.-]+)/(fetch|poll|offsets)", u.path)
        if not m:
            self.send_error(404)
            return
        topic, op = m.group(1), m.group(2)
        try:
            if op == "fetch":
                recs = self.broker.fetch(topic, int(q.get("offset", 0)),
                                         int(q["max"]) if "max" in q else None)
                self._json({"records": recs})
            elif op == "poll":
                recs = self.broker.poll(topic, q["group"],
                                        int(q["max"]) if "max" in q else None)
                self._json({"records": recs})
            else:
                self._json({"end": self.broker.end_offset(topic),
                            "committed": self.broker.committed(topic, q["group"])
                            if "group" in q else None})
        except (KeyError, ValueError) as e:
            self._json({"error": str(e)}, code=400)

    def do_POST(self):
        u = urlparse(self.path)
        m = re.fullmatch(r"/topics/([\w.-]+)/(publish|commit)", u.path)
        if not m:
            self.send_error(404)
            return
        topic, op = m.group(1), m.group(2)
        length = int(self.headers.get("Content-Length", 0))
        try:
            body = json.loads(self.rfile.read(length) or b"{}")
            if op == "publish":
                values = body["values"] if "values" in body else [body["value"]]
                offs = self.broker.publish_batch(topic, values, key=body.get("key"))
                self._json({"offsets": offs})
            else:
                self.broker.commit(topic, body["group"], int(body["offset"]))
                self._json({"ok": True})
        except (KeyError, ValueError, json.JSONDecodeError) as e:
            self._json({"error": str(e)}, code=400)


class IngestServer:
    """Threaded HTTP broker service over a file-backed Broker root."""

    def __init__(self, root: str, host: str = "127.0.0.1", port: int = 0):
        self.broker = Broker(root)
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.broker = self.broker  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "IngestServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)


class HttpBrokerClient:
    """Producer/consumer API against an IngestServer — mirrors Broker's
    surface so telemetry tooling works over either transport."""

    def __init__(self, base_url: str):
        self.base_url = base_url.rstrip("/")

    def _req(self, method: str, path: str, body=None):
        import urllib.request

        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(self.base_url + path, data=data, method=method,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            out = json.loads(r.read())
        if isinstance(out, dict) and out.get("error"):
            raise ValueError(out["error"])
        return out

    def publish(self, topic: str, value, key: str | None = None) -> int:
        return self.publish_batch(topic, [value], key=key)[0]

    def publish_batch(self, topic: str, values, key: str | None = None):
        body = {"values": list(values)}
        if key is not None:
            body["key"] = key
        return self._req("POST", f"/topics/{topic}/publish", body)["offsets"]

    def topics(self):
        return self._req("GET", "/topics")["topics"]

    def end_offset(self, topic: str) -> int:
        return self._req("GET", f"/topics/{topic}/offsets")["end"]

    def fetch(self, topic: str, offset: int = 0, max_records=None):
        q = f"?offset={offset}" + (f"&max={max_records}" if max_records else "")
        return self._req("GET", f"/topics/{topic}/fetch{q}")["records"]

    def poll(self, topic: str, group: str, max_records=None):
        q = f"?group={group}" + (f"&max={max_records}" if max_records else "")
        return self._req("GET", f"/topics/{topic}/poll{q}")["records"]

    def commit(self, topic: str, group: str, offset: int) -> None:
        self._req("POST", f"/topics/{topic}/commit",
                  {"group": group, "offset": int(offset)})

    def committed(self, topic: str, group: str) -> int:
        return self._req("GET", f"/topics/{topic}/offsets?group={group}")["committed"]
