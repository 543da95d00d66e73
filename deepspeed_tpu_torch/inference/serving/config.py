"""The serving config (counterpart of
``deepspeed_tpu/inference/serving/config.py``), as a dataclass.

The JAX package resolves some knobs through env and process-wide layers;
the port takes them from this config alone. It takes every field of the
JAX config; those that ask for what the port does not do yet raise
``NotImplementedError`` naming the later slice (``ROADMAP.md`` Queue A):
content-hashed prefix caching, speculative decoding, the ``"dense"`` KV
write, admission by KV bytes, serving telemetry and the heartbeat. So the
port's defaults ask for none of them: ``prefix_cache="off"``,
``tick_telemetry_every=0`` and ``heartbeat_interval=0.0``, where the JAX
defaults are ``None`` (resolved to ``"on"``), 1 and 1.0; passing those JAX
defaults raises."""

import dataclasses
from typing import Optional

WEIGHT_DTYPE_CHOICES = ("fp", "int8", "int4")
PREFIX_CACHE_CHOICES = ("on", "off")
KV_WRITE_CHOICES = ("scatter", "dense")

_LATER = "is a later slice of the PyTorch port (ROADMAP.md Queue A)"


@dataclasses.dataclass
class ServingConfig:
    #: decode slots (in-flight request capacity); bucketed to the next power of two
    slots: int = 8
    #: KV block granularity for admission control (tokens per block)
    page_size: int = 16
    #: total KV token budget backing admission; None = slots x model context
    kv_pool_tokens: Optional[int] = None
    #: total KV byte budget backing admission (JAX: converted to tokens from
    #: the cache's per-token footprint); only None is ported
    kv_pool_bytes: Optional[int] = None
    #: chunked prefill: prompt tokens consumed per prefill tick
    prefill_chunk: int = 16
    #: decode ticks guaranteed between two prefill ticks while decodes are
    #: in flight (0 = prefill greedily)
    prefill_interleave: int = 1
    #: queued requests beyond this are refused on submit
    max_queue: int = 1024
    #: int8 KV pools (codes + per-(slot, position, head) scales)
    kv_quant: bool = True
    #: per-slot KV append: None or "scatter" (the port's row write, whose
    #: parked-slot rows drop as JAX's scatter does); "dense" is not ported
    kv_write: Optional[str] = None
    #: served weight dtype: "fp" (None) or per-group "int8"/"int4" codes
    #: with the dequantisation fused into the GEMM (kernel K2)
    weight_dtype: Optional[str] = None
    #: target rows per quantization group along the contraction axis
    weight_group_size: int = 64
    #: content-hashed KV prefix caching: "off"; "on" and None (JAX's default,
    #: which resolves to "on") are not ported
    prefix_cache: Optional[str] = "off"
    speculation: Optional[dict] = None
    #: serve_tick telemetry every N ticks; only 0 (none) is ported
    tick_telemetry_every: int = 0
    #: serving-role heartbeat cadence in seconds; only 0.0 (none) is ported
    heartbeat_interval: float = 0.0
    #: sampling (scheduler-global)
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        for name in ("slots", "page_size", "prefill_chunk", "max_queue", "weight_group_size"):
            if int(getattr(self, name)) < 1:
                raise ValueError(f"ServingConfig.{name} must be >= 1, got {getattr(self, name)}")
        if self.prefill_interleave < 0:
            raise ValueError("ServingConfig.prefill_interleave must be >= 0")
        if self.weight_dtype is not None and self.weight_dtype not in WEIGHT_DTYPE_CHOICES:
            raise ValueError(f"unknown weight_dtype {self.weight_dtype!r}; choices: "
                             f"{list(WEIGHT_DTYPE_CHOICES)}")
        if self.tick_telemetry_every < 0 or self.heartbeat_interval < 0:
            raise ValueError("ServingConfig.tick_telemetry_every and heartbeat_interval must be "
                             ">= 0")
        for name, choices in (("prefix_cache", PREFIX_CACHE_CHOICES),
                              ("kv_write", KV_WRITE_CHOICES)):
            value = getattr(self, name)
            if value is not None and value not in choices:
                raise ValueError(f"unknown {name} {value!r}; choices: {list(choices)}")
        if self.prefix_cache in (None, "on"):  # None is JAX's default, resolved to "on"
            raise NotImplementedError(f"content-hashed KV prefix caching {_LATER}; use "
                                      "prefix_cache='off'")
        if self.speculation and self.speculation.get("enabled", False):
            raise NotImplementedError(f"speculative decoding {_LATER}")
        if self.kv_write == "dense":
            raise NotImplementedError(f"the dense KV write {_LATER}; use kv_write=None or "
                                      "'scatter'")
        if self.kv_pool_bytes is not None:
            raise NotImplementedError(f"admission by KV bytes (kv_pool_bytes) {_LATER}; use "
                                      "kv_pool_tokens")
        if self.tick_telemetry_every > 0:
            raise NotImplementedError(f"serving telemetry (tick_telemetry_every) {_LATER}; use 0")
        if self.heartbeat_interval > 0:
            raise NotImplementedError(f"the serving heartbeat (heartbeat_interval) {_LATER}; "
                                      "use 0.0")

    @property
    def resolved_weight_dtype(self) -> str:
        return self.weight_dtype or "fp"
