"""File-backed pub/sub broker: durable topic logs + consumer-group offsets.

The storage model mirrors Kafka's (the reference's claimed ingestion broker,
README.md:48,55): a topic is an append-only record log addressed by offset;
consumers poll from an offset and commit per consumer-group positions, so a
restarted consumer resumes where it left off and independent groups each see
the full stream.

Layout under ``root``::

    <root>/<topic>/log.jsonl           one JSON record per line (offset = line no.)
    <root>/<topic>/offsets/<group>     committed next-offset, as text

Appends go through a per-process lock plus O_APPEND writes, so concurrent
producers in one process are safe and multi-process appends never interleave
within a line. This is a control-plane component (telemetry rates, not HBM
rates); the hot path of the framework stays in ckks/ops.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Sequence

_SAFE = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_-.")


def _check_name(name: str) -> str:
    if not name or any(c not in _SAFE for c in name):
        raise ValueError(f"invalid topic/group name {name!r}")
    return name


class Broker:
    """Local (shared-filesystem) broker handle. Multiple Broker instances —
    including in different processes — may point at the same root."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()

    # -- paths ---------------------------------------------------------------

    def _topic_dir(self, topic: str) -> str:
        return os.path.join(self.root, _check_name(topic))

    def _log_path(self, topic: str) -> str:
        return os.path.join(self._topic_dir(topic), "log.jsonl")

    def _offset_path(self, topic: str, group: str) -> str:
        return os.path.join(self._topic_dir(topic), "offsets", _check_name(group))

    # -- producer side ---------------------------------------------------------

    def publish(self, topic: str, value: Any, key: str | None = None) -> int:
        """Append one record; returns its offset."""
        return self.publish_batch(topic, [value], key=key)[0]

    def publish_batch(self, topic: str, values: Sequence[Any],
                      key: str | None = None) -> List[int]:
        d = self._topic_dir(topic)
        os.makedirs(d, exist_ok=True)
        path = self._log_path(topic)
        with self._lock:
            start = self.end_offset(topic)
            lines = []
            for i, v in enumerate(values):
                rec = {"offset": start + i, "ts": time.time(), "value": v}
                if key is not None:
                    rec["key"] = key
                lines.append(json.dumps(rec))
            with open(path, "a") as f:
                f.write("\n".join(lines) + "\n")
        return list(range(start, start + len(values)))

    # -- consumer side ---------------------------------------------------------

    def topics(self) -> List[str]:
        return sorted(
            t for t in os.listdir(self.root)
            if os.path.isfile(self._log_path(t))
        )

    def end_offset(self, topic: str) -> int:
        path = self._log_path(topic)
        if not os.path.exists(path):
            return 0
        with open(path) as f:
            return sum(1 for line in f if line.strip())

    def fetch(self, topic: str, offset: int = 0,
              max_records: int | None = None) -> List[Dict[str, Any]]:
        """Records [offset, offset+max_records) — empty list past the end."""
        path = self._log_path(topic)
        if not os.path.exists(path):
            return []
        out: List[Dict[str, Any]] = []
        with open(path) as f:
            for i, line in enumerate(f):
                if i < offset or not line.strip():
                    continue
                out.append(json.loads(line))
                if max_records is not None and len(out) >= max_records:
                    break
        return out

    def commit(self, topic: str, group: str, offset: int) -> None:
        """Record ``offset`` as the group's next-to-read position."""
        path = self._offset_path(topic, group)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(int(offset)))
        os.replace(tmp, path)

    def committed(self, topic: str, group: str) -> int:
        path = self._offset_path(topic, group)
        if not os.path.exists(path):
            return 0
        with open(path) as f:
            return int(f.read().strip() or 0)

    def poll(self, topic: str, group: str,
             max_records: int | None = None) -> List[Dict[str, Any]]:
        """Group-positioned fetch: read from the group's committed offset and
        auto-commit past what was returned (at-most-once per group)."""
        start = self.committed(topic, group)
        recs = self.fetch(topic, start, max_records)
        if recs:
            self.commit(topic, group, recs[-1]["offset"] + 1)
        return recs
