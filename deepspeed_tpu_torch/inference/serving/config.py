"""The serving config (counterpart of
``deepspeed_tpu/inference/serving/config.py``), as a dataclass.

The JAX package resolves some knobs through env and process-wide layers;
the port takes them from this config alone. Content-hashed prefix caching
and speculative decoding are later slices of the port and raise when asked
for, so the port's default is ``prefix_cache="off"`` (the JAX default is
``"on"``)."""

import dataclasses
from typing import Optional

WEIGHT_DTYPE_CHOICES = ("fp", "int8", "int4")
PREFIX_CACHE_CHOICES = ("on", "off")


@dataclasses.dataclass
class ServingConfig:
    #: decode slots (in-flight request capacity); bucketed to the next power of two
    slots: int = 8
    #: KV block granularity for admission control (tokens per block)
    page_size: int = 16
    #: total KV token budget backing admission; None = slots x model context
    kv_pool_tokens: Optional[int] = None
    #: chunked prefill: prompt tokens consumed per prefill tick
    prefill_chunk: int = 16
    #: decode ticks guaranteed between two prefill ticks while decodes are
    #: in flight (0 = prefill greedily)
    prefill_interleave: int = 1
    #: queued requests beyond this are refused on submit
    max_queue: int = 1024
    #: int8 KV pools (codes + per-(slot, position, head) scales)
    kv_quant: bool = True
    #: served weight dtype: "fp" (None) or per-group "int8"/"int4" codes
    #: with the dequantisation fused into the GEMM (kernel K2)
    weight_dtype: Optional[str] = None
    #: target rows per quantization group along the contraction axis
    weight_group_size: int = 64
    prefix_cache: str = "off"
    speculation: Optional[dict] = None
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
        if self.prefix_cache not in PREFIX_CACHE_CHOICES:
            raise ValueError(f"unknown prefix_cache {self.prefix_cache!r}; choices: "
                             f"{list(PREFIX_CACHE_CHOICES)}")
        if self.prefix_cache == "on":
            raise NotImplementedError("content-hashed KV prefix caching is a later slice of the "
                                      "PyTorch port (ROADMAP.md Queue A); use prefix_cache='off'")
        if self.speculation and self.speculation.get("enabled", False):
            raise NotImplementedError("speculative decoding is a later slice of the PyTorch port "
                                      "(ROADMAP.md Queue A)")

    @property
    def resolved_weight_dtype(self) -> str:
        return self.weight_dtype or "fp"
