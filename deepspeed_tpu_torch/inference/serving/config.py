"""The serving config (counterpart of
``deepspeed_tpu/inference/serving/config.py``), as a dataclass with the
JAX config's fields and defaults: content-hashed prefix caching on
(``prefix_cache=None`` resolves to ``"on"``), a ``serve_tick`` event every
tick when a telemetry bus is attached, a heartbeat each second when a
supervisor set ``DS_ELASTIC_HEARTBEAT_FILE``.

The JAX package resolves ``kv_write``, ``weight_dtype`` and
``prefix_cache`` through process-wide defaults and ``DS_SERVE_*`` env
layers; the port takes them from this config alone."""

import dataclasses
from typing import Optional, Union

WEIGHT_DTYPE_CHOICES = ("fp", "int8", "int4")
PREFIX_CACHE_CHOICES = ("on", "off")
KV_WRITE_CHOICES = ("scatter", "dense")
DEFAULT_PREFIX_CACHE = "on"
DEFAULT_KV_WRITE = "scatter"


@dataclasses.dataclass
class SpeculationConfig:
    """Speculative decoding: the drafter (a layer-reduced student of the
    target, ``compression.student_initialization``) proposes ``k`` tokens,
    the target verifies the ``k + 1`` block in one pass. Lossless under
    greedy decoding: a rejected position takes the target's own token."""

    enabled: bool = False
    #: draft tokens per round (the verify block is k + 1 wide)
    k: int = 4

    def __post_init__(self):
        if not 1 <= int(self.k) <= 16:
            raise ValueError(f"speculation.k must be in [1, 16], got {self.k}")


@dataclasses.dataclass
class ServingConfig:
    #: decode slots (in-flight request capacity); bucketed to the next power of two
    slots: int = 8
    #: KV block granularity for admission control (tokens per block)
    page_size: int = 16
    #: total KV token budget backing admission; None = slots x model context
    kv_pool_tokens: Optional[int] = None
    #: total KV byte budget backing admission, converted to tokens from the
    #: cache's per-token footprint (codes + scales under int8 KV); wins over
    #: ``kv_pool_tokens``
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
    #: per-slot KV append: "scatter" (None) or "dense", taken and reported
    #: as in JAX; both run the scatter of the new rows (JAX's dense write is
    #: a TPU layout choice with the scatter's bits)
    kv_write: Optional[str] = None
    #: served weight dtype: "fp" (None) or per-group "int8"/"int4" codes
    #: with the dequantisation fused into the GEMM (kernel K2)
    weight_dtype: Optional[str] = None
    #: target rows per quantization group along the contraction axis
    weight_group_size: int = 64
    #: content-hashed KV prefix caching: "on" (None) or "off", the private
    #: pool (the control arm)
    prefix_cache: Optional[str] = None
    #: a ``serve_tick`` telemetry event every N ticks (0: none)
    tick_telemetry_every: int = 1
    #: serving-role heartbeat cadence in seconds (a no-op unless
    #: ``DS_ELASTIC_HEARTBEAT_FILE`` is set)
    heartbeat_interval: float = 1.0
    #: sampling (scheduler-global; speculation requires greedy)
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    speculation: Union[SpeculationConfig, dict, None] = None

    def __post_init__(self):
        for name in ("slots", "page_size", "prefill_chunk", "max_queue", "weight_group_size"):
            if int(getattr(self, name)) < 1:
                raise ValueError(f"ServingConfig.{name} must be >= 1, got {getattr(self, name)}")
        if self.prefill_interleave < 0:
            raise ValueError("ServingConfig.prefill_interleave must be >= 0")
        if self.tick_telemetry_every < 0 or self.heartbeat_interval < 0:
            raise ValueError("ServingConfig.tick_telemetry_every and heartbeat_interval must be "
                             ">= 0")
        for name, choices in (("prefix_cache", PREFIX_CACHE_CHOICES),
                              ("kv_write", KV_WRITE_CHOICES),
                              ("weight_dtype", WEIGHT_DTYPE_CHOICES)):
            value = getattr(self, name)
            if value is not None and value not in choices:
                raise ValueError(f"unknown {name} {value!r}; choices: {list(choices)}")
        if self.speculation is None:
            self.speculation = SpeculationConfig()
        elif isinstance(self.speculation, dict):
            self.speculation = SpeculationConfig(**self.speculation)
        if self.speculation.enabled and self.do_sample:
            raise ValueError("speculative decoding is only lossless under greedy decoding; set "
                             "do_sample=False or disable speculation")

    @property
    def resolved_weight_dtype(self) -> str:
        return self.weight_dtype or "fp"

    @property
    def resolved_prefix_cache(self) -> str:
        return self.prefix_cache or DEFAULT_PREFIX_CACHE

    @property
    def resolved_kv_write(self) -> str:
        return self.kv_write or DEFAULT_KV_WRITE
