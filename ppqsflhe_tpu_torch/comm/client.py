"""Transfer client — the ``msend`` curl wrapper equivalent
(orchestration/helper_fns.sh:33-110): GET with 5 retries + 1 s backoff
(:56-61), POST multipart {file, client_id, type} (:84-87), a per-call
metrics CSV row (:72-73,98-99), and the reference's dual transport mode
(COMM_MODE MONGOOSE ↔ local file copy, comm_fns.sh:14-18,38-44) as
``mode='http' | 'local'``.
"""

from __future__ import annotations

import os
import shutil
import time
import urllib.error
import urllib.request
import uuid

from .metrics import MetricsLog

RETRIES = 5
BACKOFF_S = 1.0


class CommClient:
    def __init__(self, base_url: str = "", role: str = "client",
                 metrics_csv: str | None = None, mode: str = "http",
                 local_storage_root: str | None = None):
        self.base_url = base_url.rstrip("/")
        self.mode = mode
        self.local_root = local_storage_root
        self.metrics = MetricsLog(metrics_csv or "", role)

    # -- GET ----------------------------------------------------------------

    def get(self, endpoint: str, dest_path: str, client_id: str = "", type_: str = "") -> str:
        t0 = time.time()
        if self.mode == "local":
            src = os.path.join(self.local_root, endpoint.lstrip("/").replace("download/", ""))
            if endpoint == "/getCC":
                src = os.path.join(self.local_root, "CC.json")
            os.makedirs(os.path.dirname(os.path.abspath(dest_path)), exist_ok=True)
            shutil.copyfile(src, dest_path)
            size = os.path.getsize(dest_path)
            self.metrics.log("GET", endpoint, client_id, type_, os.path.basename(dest_path),
                             bytes_received=size, latency_ms=(time.time() - t0) * 1e3)
            return dest_path
        last_err: Exception | None = None
        for attempt in range(RETRIES):
            try:
                with urllib.request.urlopen(self.base_url + endpoint, timeout=60) as r:
                    data = r.read()
                os.makedirs(os.path.dirname(os.path.abspath(dest_path)), exist_ok=True)
                with open(dest_path, "wb") as f:
                    f.write(data)
                self.metrics.log("GET", endpoint, client_id, type_,
                                 os.path.basename(dest_path), bytes_received=len(data),
                                 latency_ms=(time.time() - t0) * 1e3, http_code=200)
                return dest_path
            except (urllib.error.URLError, OSError) as e:  # retry ×5 like msend
                last_err = e
                time.sleep(BACKOFF_S)
        self.metrics.log("GET", endpoint, client_id, type_, os.path.basename(dest_path),
                         latency_ms=(time.time() - t0) * 1e3, http_code=0)
        raise ConnectionError(f"GET {endpoint} failed after {RETRIES} tries: {last_err}")

    # -- POST ---------------------------------------------------------------

    def post_file(self, endpoint: str, file_path: str, client_id: str = "",
                  type_: str = "") -> None:
        t0 = time.time()
        size = os.path.getsize(file_path)
        if self.mode == "local":
            # local-cp transport: map upload endpoints onto the storage layout
            from .server import UPLOAD_DIRS
            import re

            m = re.fullmatch(r"/upload([A-Za-z]+)C(\d+)", endpoint)
            kind, cid = (m.group(1), m.group(2)) if m else ("Aggregated", "0")
            sub = UPLOAD_DIRS.get(kind, "client_{cid}").format(cid=cid)
            dest = os.path.join(self.local_root, sub, os.path.basename(file_path))
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            shutil.copyfile(file_path, dest)
            self.metrics.log("POST", endpoint, client_id, type_, os.path.basename(file_path),
                             payload_size=size, bytes_sent=size,
                             latency_ms=(time.time() - t0) * 1e3)
            return
        boundary = uuid.uuid4().hex
        with open(file_path, "rb") as f:
            fdata = f.read()
        parts = []
        for name, value in (("client_id", client_id), ("type", type_)):
            parts.append(
                f"--{boundary}\r\nContent-Disposition: form-data; name=\"{name}\"\r\n\r\n{value}\r\n".encode()
            )
        parts.append(
            f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{os.path.basename(file_path)}\"\r\n"
            f"Content-Type: application/octet-stream\r\n\r\n".encode()
            + fdata + b"\r\n"
        )
        parts.append(f"--{boundary}--\r\n".encode())
        body = b"".join(parts)
        req = urllib.request.Request(
            self.base_url + endpoint, data=body, method="POST",
            headers={"Content-Type": f"multipart/form-data; boundary={boundary}"},
        )
        with urllib.request.urlopen(req, timeout=300) as r:
            code = r.status
        self.metrics.log("POST", endpoint, client_id, type_, os.path.basename(file_path),
                         payload_size=size, bytes_sent=len(body),
                         latency_ms=(time.time() - t0) * 1e3, http_code=code)
