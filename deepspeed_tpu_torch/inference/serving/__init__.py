"""Continuous in-flight batching with chunked prefill, content-hashed
prefix caching and speculative decoding (counterpart of
``deepspeed_tpu/inference/serving/``)."""

from deepspeed_tpu_torch.inference.serving.blocks import (BlockPool, PrefixMatch, chain_hash,
                                                          prefix_key)
from deepspeed_tpu_torch.inference.serving.config import ServingConfig, SpeculationConfig
from deepspeed_tpu_torch.inference.serving.events import (SERVE_EVENT_SCHEMAS, iter_serve_events,
                                                          last_tick_signals, validate_event)
from deepspeed_tpu_torch.inference.serving.programs import (make_slot_cache, serve_programs,
                                                            slot_capacity, stamp_lengths)
from deepspeed_tpu_torch.inference.serving.queue import RequestQueue
from deepspeed_tpu_torch.inference.serving.request import (ACTIVE, FINISHED, PREFILL, QUEUED,
                                                           REFUSED, Request)
from deepspeed_tpu_torch.inference.serving.scheduler import ContinuousBatchingScheduler

__all__ = [
    "ACTIVE", "FINISHED", "PREFILL", "QUEUED", "REFUSED",
    "BlockPool", "ContinuousBatchingScheduler", "PrefixMatch", "Request", "RequestQueue",
    "SERVE_EVENT_SCHEMAS", "ServingConfig", "SpeculationConfig", "chain_hash",
    "iter_serve_events", "last_tick_signals", "make_slot_cache", "prefix_key",
    "serve_programs", "slot_capacity", "stamp_lengths", "validate_event",
]
