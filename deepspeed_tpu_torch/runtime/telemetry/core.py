"""RuntimeTelemetry: the facade over spans, metrics and the JSONL sink
(counterpart of ``deepspeed_tpu/runtime/telemetry/core.py``), as far as
the serving scheduler uses it: spans, step windows, structured events,
the run header and close.

Every ``flush_every`` steps one ``spans`` event (the raw timeline), one
``step_window`` event (per-phase aggregates) and one ``drift`` event
(measured memory: ``torch.cuda.memory_stats`` peaks on the card, host peak
RSS always) are written. The training engine's spans, ``DS_TRACE_STEPS``
and the static price of a step are later slices of the port.
"""

import dataclasses
import os
import time
from typing import Any, Dict, Optional

from deepspeed_tpu_torch.runtime.telemetry.metrics import Histogram, MetricsRegistry
from deepspeed_tpu_torch.runtime.telemetry.sink import TELEMETRY_SCHEMA_VERSION, JsonlSink
from deepspeed_tpu_torch.runtime.telemetry.spans import SpanRecorder

__all__ = ["RuntimeTelemetry", "TelemetryConfig", "measured_memory", "TELEMETRY_FILE"]

TELEMETRY_FILE = "telemetry.jsonl"


@dataclasses.dataclass
class TelemetryConfig:
    """The ``telemetry`` block (the JAX ``TelemetryConfig`` fields the
    facade reads): the run directory is ``<output_path>/<job_name>``."""

    enabled: bool = False
    output_path: str = "./telemetry_logs"
    job_name: str = "DeepSpeedJobName"
    #: span and drift window cadence in steps (0: the facade's default)
    flush_interval_steps: int = 0
    #: write the raw span timeline beside the per-window aggregates
    span_events: bool = True
    max_buffered_spans: int = 4096


def measured_memory() -> Dict[str, int]:
    """Memory observations: the card's allocator peaks where CUDA is up,
    and host peak RSS always."""
    out: Dict[str, int] = {}
    try:
        import torch
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            stats = torch.cuda.memory_stats()
            for src, dst in (("allocated_bytes.all.peak", "device_peak_bytes"),
                             ("allocated_bytes.all.current", "device_bytes_in_use")):
                if src in stats:
                    out[dst] = int(stats[src])
    except Exception:  # noqa: BLE001 - observability never raises
        pass
    try:
        import resource
        out["host_peak_rss_bytes"] = int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
    except Exception:  # noqa: BLE001
        pass
    return out


class RuntimeTelemetry:
    """The facade a loop owns. Disabled (``cfg.enabled`` false) every call
    is a no-op and ``span()`` hands out the shared null span."""

    def __init__(self, cfg: Optional[TelemetryConfig] = None, flush_every: int = 10,
                 rank: int = 0):
        self.cfg = cfg
        self.enabled = bool(cfg is not None and cfg.enabled)
        self.rank = int(rank)
        self.flush_every = max(int(getattr(cfg, "flush_interval_steps", 0) or 0)
                               or int(flush_every), 1)
        self.metrics = MetricsRegistry()
        self.spans = SpanRecorder(
            enabled=self.enabled, max_buffered=int(getattr(cfg, "max_buffered_spans", 4096) or 4096))
        self.run_dir: Optional[str] = None
        self.sink = JsonlSink(None)
        if self.enabled:
            self.run_dir = os.path.join(cfg.output_path or "./telemetry_logs",
                                        cfg.job_name or "run")
            self.sink = JsonlSink(os.path.join(self.run_dir, TELEMETRY_FILE), rank=self.rank)
        self._header_written = False
        self._step_t0: Optional[float] = None
        self._window_steps = 0

    # -- run header ----------------------------------------------------
    def write_run_header(self, run_info: Optional[Dict] = None) -> None:
        if not self.enabled or self._header_written:
            return
        self._header_written = True
        self.sink.write({"event": "run_start", "schema": TELEMETRY_SCHEMA_VERSION,
                         "run": dict(run_info or {}), "static_price": None}, flush=True)

    # -- spans / steps -------------------------------------------------
    def span(self, name: str):
        return self.spans.span(name)

    def begin_step(self, step: int) -> None:
        if not self.enabled:
            return
        self._step_t0 = time.perf_counter()

    def end_step(self, step: int) -> None:
        """Close the step's record; at ``flush_every`` cadence write the
        window's spans, aggregates and drift."""
        if not self.enabled or self._step_t0 is None:
            return
        wall = time.perf_counter() - self._step_t0
        self._step_t0 = None
        self.spans._window_hist.setdefault("step", Histogram()).record(wall)
        self._window_steps += 1
        if step % self.flush_every == 0 or self._window_steps >= self.flush_every:
            self.flush_window(step)

    def flush_window(self, step: int) -> None:
        if not self.enabled:
            return
        events, hists, dropped = self.spans.drain()
        self._window_steps = 0
        if not self.sink.active:
            return
        if events and self.cfg.span_events:
            self.sink.write({"event": "spans", "step": step, "dropped": dropped, "spans": events})
        if hists:  # an empty window (explicit flush, no steps) writes nothing
            window = {"event": "step_window", "step": step,
                      "phases": {name: h.snapshot() for name, h in hists.items()}}
            snap = self.metrics.snapshot()
            if snap:
                window["metrics"] = snap
            self.sink.write(window)
            step_hist = hists.get("step")
            self.sink.write({"event": "drift", "step": step,
                             "window_steps": step_hist.count if step_hist else 0,
                             "median_step_s": step_hist.percentile(50) if step_hist else None,
                             "predicted": None, "measured": measured_memory(), "ratios": {}})
        self.sink.flush()

    # -- raw events ----------------------------------------------------
    def emit(self, kind: str, /, flush: bool = True, **fields: Any) -> None:
        """Write one structured event; a no-op when disabled. ``kind`` is
        positional-only so an event may carry a field named ``kind``;
        ``flush=False`` leaves the line buffered until the window flush."""
        if not self.enabled:
            return
        rec = {"event": kind}
        rec.update(fields)
        self.sink.write(rec, flush=flush)

    def close(self) -> None:
        self.sink.close()
