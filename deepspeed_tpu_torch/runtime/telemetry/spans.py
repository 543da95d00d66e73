"""Nested wall-clock spans around the host-side phases a loop drives
(counterpart of ``deepspeed_tpu/runtime/telemetry/spans.py``).

A disabled recorder's ``span()`` returns one shared no-op context manager:
no allocation on the hot path. An enabled one costs two ``perf_counter``
calls, one list append and one histogram record per span; the JSONL write
happens only at window flush (``RuntimeTelemetry``).
"""

import time
from typing import Dict, List, Optional, Tuple

from deepspeed_tpu_torch.runtime.telemetry.metrics import Histogram

__all__ = ["SpanRecorder", "NULL_SPAN"]


class _NullSpan:
    """Shared no-op context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_rec", "name", "_t0", "_ts")

    def __init__(self, rec: "SpanRecorder", name: str):
        self._rec = rec
        self.name = name

    def __enter__(self):
        rec = self._rec
        rec._stack.append(self.name)
        rec.last_span = self.name
        self._ts = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        rec = self._rec
        rec._stack.pop()
        rec._record(self.name, tuple(rec._stack), self._ts, dur)
        return False


class SpanRecorder:
    """Collects completed spans into a bounded buffer + per-window
    histograms; ``drain()`` hands both to the telemetry window flush."""

    def __init__(self, enabled: bool = True, max_buffered: int = 4096):
        self.enabled = enabled
        self.max_buffered = int(max_buffered)
        self.last_span: Optional[str] = None  # liveness breadcrumb (heartbeat payload)
        self._stack: List[str] = []
        self._events: List[Dict] = []
        self._dropped = 0
        self._window_hist: Dict[str, Histogram] = {}

    def span(self, name: str):
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name)

    def _record(self, name: str, path: Tuple[str, ...], ts: float, dur: float) -> None:
        if len(self._events) < self.max_buffered:
            self._events.append({"name": name, "path": "/".join(path),
                                 "ts": ts, "dur_s": dur, "depth": len(path)})
        else:
            self._dropped += 1
        h = self._window_hist.get(name)
        if h is None:
            h = self._window_hist[name] = Histogram()
        h.record(dur)

    def drain(self) -> Tuple[List[Dict], Dict[str, Histogram], int]:
        """Return (buffered span events, per-phase window histograms,
        dropped count) and reset the window."""
        events, hists, dropped = self._events, self._window_hist, self._dropped
        self._events, self._window_hist, self._dropped = [], {}, 0
        return events, hists, dropped
