"""Runtime telemetry of the port (counterpart of
``deepspeed_tpu/runtime/telemetry/``): counters, gauges and mergeable
histograms (``metrics``), nested host-side spans (``spans``), the
schema-versioned JSONL event log (``sink``) and the facade over them
(``core``)."""

from deepspeed_tpu_torch.runtime.telemetry.core import (TELEMETRY_FILE, RuntimeTelemetry,
                                                        TelemetryConfig, measured_memory)
from deepspeed_tpu_torch.runtime.telemetry.metrics import (DEFAULT_LATENCY_BOUNDS, Counter, Gauge,
                                                           Histogram, MetricsRegistry)
from deepspeed_tpu_torch.runtime.telemetry.sink import (TELEMETRY_SCHEMA_VERSION, JsonlSink,
                                                        iter_events, read_events)
from deepspeed_tpu_torch.runtime.telemetry.spans import NULL_SPAN, SpanRecorder

__all__ = ["RuntimeTelemetry", "TelemetryConfig", "measured_memory", "TELEMETRY_FILE",
           "Counter", "Gauge", "Histogram", "MetricsRegistry", "DEFAULT_LATENCY_BOUNDS",
           "TELEMETRY_SCHEMA_VERSION", "JsonlSink", "iter_events", "read_events",
           "NULL_SPAN", "SpanRecorder"]
