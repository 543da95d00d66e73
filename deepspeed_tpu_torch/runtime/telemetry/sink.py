"""Schema-versioned JSONL event sink (counterpart of
``deepspeed_tpu/runtime/telemetry/sink.py``).

One line per event, appended to ``telemetry.jsonl`` under the run
directory, rank 0 only. Each line lands as one ``write()`` of a complete
record on a file opened in append mode, so concurrent writers interleave
at line granularity. Flushing is batched at window cadence.

The ``run_start`` header's ``schema`` covers the whole file; readers skip
lines they cannot parse, so a torn tail never loses the rest.
"""

import json
import os
import time
from typing import Dict, Iterator, List, Optional

__all__ = ["TELEMETRY_SCHEMA_VERSION", "JsonlSink", "read_events", "iter_events"]

#: bump when an event's FIELD SEMANTICS change (adding fields is free —
#: readers must ignore unknown fields)
TELEMETRY_SCHEMA_VERSION = 1


class JsonlSink:
    """Lazy append-only JSONL writer; a no-op off rank 0 or when closed."""

    def __init__(self, path: Optional[str], rank: int = 0):
        self.path = path
        self.rank = rank
        self._fh = None
        self._closed = False

    @property
    def active(self) -> bool:
        return self.path is not None and self.rank == 0 and not self._closed

    def write(self, record: Dict, flush: bool = False) -> None:
        if not self.active:
            return
        if self._fh is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._fh = open(self.path, "a", buffering=1 << 16)
        record.setdefault("t", time.time())
        try:
            line = json.dumps(record, separators=(",", ":"), default=_coerce)
        except (TypeError, ValueError):
            # a bad payload must never kill a training step
            line = json.dumps({"event": "encode_error",
                               "kind": str(record.get("event")), "t": record["t"]})
        self._fh.write(line + "\n")
        if flush:
            self._fh.flush()

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.flush()
                self._fh.close()
            except OSError:
                pass
            self._fh = None
        self._closed = True


def _coerce(obj):
    """Best-effort JSON coercion for numpy arrays, tensors and scalars in
    payloads (tolist covers them; item as the scalar fallback)."""
    for attr in ("tolist", "item"):
        fn = getattr(obj, attr, None)
        if callable(fn):
            try:
                return fn()
            except Exception:  # noqa: BLE001 — try the next / fall through
                continue
    return str(obj)


def iter_events(path: str) -> Iterator[Dict]:
    """Yield parsed events, skipping corrupt/partial lines (a crashed
    writer leaves at most one torn tail line — never lose the rest)."""
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                yield rec


def read_events(path: str) -> List[Dict]:
    return list(iter_events(path))
