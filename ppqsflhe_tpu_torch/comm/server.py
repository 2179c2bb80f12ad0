"""HTTP artifact-exchange server — runMserver replacement
(server/src/runMserver.cpp; endpoints :237-285).

Same route contract as the reference Mongoose server:

  GET  /getCC                  → the serialized CryptoContext
  GET  /sendPbKeyC<i>          → client i's uploaded public key
  GET  /download/<relpath>     → any file under the storage root
  POST /upload<Kind>C<i>       → multipart {file, client_id, type}

plus /healthz. Python stdlib ThreadingHTTPServer is plenty for the control
plane (the reference measured 36-96 ms per 37 MB upload server-side —
SURVEY.md §6); the port's C++ native server
(``ppqsflhe_tpu_torch/runtime/artifact_server.cpp``, built by
``runtime.build_native()`` into ``build/ppqsflhe_tpu_torch/runtime/bin/``)
is a drop-in for deployments that need it.
"""

from __future__ import annotations

import os
import re
import threading
import time
from email.parser import BytesParser
from email.policy import default as email_default
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .metrics import MetricsLog

UPLOAD_DIRS = {
    # kind → subdirectory under storage root (mirrors sConfig.json paths)
    "PubKey": "client_{cid}",
    "ReKey": "client_{cid}",
    "EncWeights": "client_{cid}",
    "DomainChanged": "client_{cid}",
    "Aggregated": "",
}


class _Handler(BaseHTTPRequestHandler):
    server_version = "ppqsflhe-tpu/0.1"

    # quiet default logging; metrics CSV is the record
    def log_message(self, fmt, *args):
        pass

    @property
    def storage(self) -> str:
        return self.server.storage_root  # type: ignore[attr-defined]

    @property
    def metrics(self) -> MetricsLog:
        return self.server.metrics  # type: ignore[attr-defined]

    def _send_file(self, path: str, endpoint: str):
        t0 = time.time()
        if not os.path.isfile(path):
            self.send_error(404, "not found")
            self.metrics.log("GET", endpoint, file=os.path.basename(path),
                             http_code=404, latency_ms=(time.time() - t0) * 1e3)
            return
        with open(path, "rb") as f:
            data = f.read()
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)
        self.metrics.log("GET", endpoint, file=os.path.basename(path),
                         bytes_sent=len(data), latency_ms=(time.time() - t0) * 1e3)

    def do_GET(self):
        if self.path == "/healthz":
            self.send_response(200)
            self.end_headers()
            self.wfile.write(b"ok")
            return
        if self.path == "/getCC":
            self._send_file(os.path.join(self.storage, "CC.json"), "/getCC")
            return
        m = re.fullmatch(r"/sendPbKeyC(\d+)", self.path)
        if m:
            cid = m.group(1)
            self._send_file(
                os.path.join(self.storage, f"client_{cid}", f"client_{cid}-public.key"),
                self.path,
            )
            return
        if self.path.startswith("/download/"):
            rel = os.path.normpath(self.path[len("/download/"):])
            if rel.startswith(".."):
                self.send_error(403)
                return
            self._send_file(os.path.join(self.storage, rel), "/download")
            return
        self.send_error(404)

    def do_POST(self):
        t0 = time.time()
        m = re.fullmatch(r"/upload([A-Za-z]+)C(\d+)", self.path)
        if not m and self.path != "/uploadAggregated":
            self.send_error(404)
            return
        kind = m.group(1) if m else "Aggregated"
        cid = m.group(2) if m else "0"
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        # multipart parse (reference: mg_http_next_multipart, runMserver.cpp:160-170)
        ctype = self.headers.get("Content-Type", "")
        fields = {}
        fname = None
        fdata = None
        if "multipart/form-data" in ctype:
            msg = BytesParser(policy=email_default).parsebytes(
                b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body
            )
            for part in msg.iter_parts():
                name = part.get_param("name", header="content-disposition")
                if name == "file":
                    fname = part.get_filename() or "upload.bin"
                    fdata = part.get_payload(decode=True)
                else:
                    fields[name] = part.get_content().strip()
        else:
            fname = "upload.bin"
            fdata = body
        if fdata is None:
            self.send_error(400, "no file part")
            return
        sub = UPLOAD_DIRS.get(kind, "client_{cid}").format(cid=cid)
        dest_dir = os.path.join(self.storage, sub)
        os.makedirs(dest_dir, exist_ok=True)
        dest = os.path.join(dest_dir, os.path.basename(fname))
        with open(dest, "wb") as f:
            f.write(fdata)
        self.send_response(200)
        self.end_headers()
        self.wfile.write(b"ok")
        self.metrics.log(
            "POST", self.path, client_id=fields.get("client_id", cid),
            type_=fields.get("type", kind), file=os.path.basename(fname),
            payload_size=len(fdata), bytes_received=length,
            latency_ms=(time.time() - t0) * 1e3,
        )


class ArtifactServer:
    """Threaded artifact server with the reference's endpoint contract."""

    def __init__(self, storage_root: str, host: str = "127.0.0.1", port: int = 8080,
                 metrics_csv: str | None = None):
        os.makedirs(storage_root, exist_ok=True)
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.storage_root = storage_root  # type: ignore[attr-defined]
        self.httpd.metrics = MetricsLog(metrics_csv or "", "server")  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "ArtifactServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
