"""Communication metrics CSVs — the reference's observability contract
(orchestration/helper_fns.sh:15-23 client side, server/src/runMserver.cpp:20-48
server side; schema SURVEY.md §2.4 item 5):

timestamp,role,method,endpoint,client_id,type,file,payload_size,bytes_sent,
bytes_received,latency_ms,http_code
"""

from __future__ import annotations

import csv
import os
import threading
from datetime import datetime

HEADER = [
    "timestamp", "role", "method", "endpoint", "client_id", "type", "file",
    "payload_size", "bytes_sent", "bytes_received", "latency_ms", "http_code",
]


class MetricsLog:
    def __init__(self, path: str, role: str):
        self.path = path
        self.role = role
        self._lock = threading.Lock()
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            if not os.path.exists(path):
                with open(path, "w", newline="") as f:
                    csv.writer(f).writerow(HEADER)

    def log(self, method: str, endpoint: str, client_id: str = "", type_: str = "",
            file: str = "", payload_size: int = 0, bytes_sent: int = 0,
            bytes_received: int = 0, latency_ms: float = 0.0, http_code: int = 200):
        if not self.path:
            return
        row = [
            datetime.now().isoformat(timespec="seconds"), self.role, method,
            endpoint, client_id, type_, file, payload_size, bytes_sent,
            bytes_received, f"{latency_ms:.1f}", http_code,
        ]
        with self._lock, open(self.path, "a", newline="") as f:
            csv.writer(f).writerow(row)
