"""Serving request: the unit the continuous-batching scheduler admits,
decodes and retires (counterpart of
``deepspeed_tpu/inference/serving/request.py``). Host-side bookkeeping only:
tokens live in numpy, timing in the scheduler's injected clock."""

import dataclasses
import itertools
from typing import List, Optional

import numpy as np

# request lifecycle (terminal states: FINISHED / REFUSED)
QUEUED = "queued"        # submitted, waiting for a slot + KV blocks
PREFILL = "prefill"      # admitted; prompt streaming in prefill chunks
ACTIVE = "active"        # decoding (prompt fully prefilled)
FINISHED = "finished"    # eos or max_new_tokens reached; blocks freed
REFUSED = "refused"      # queue overflow, oversize prompt, or drain

_ids = itertools.count()


@dataclasses.dataclass
class Request:
    """One generation request plus its serving statistics."""

    prompt: np.ndarray                    # [prompt_len] int32
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    arrival_time: Optional[float] = None  # stamped by the queue's clock
    request_id: int = dataclasses.field(default_factory=lambda: next(_ids))

    state: str = QUEUED
    refuse_reason: str = ""
    output: List[int] = dataclasses.field(default_factory=list)
    prefill_pos: int = 0                  # prompt tokens already prefilled
    #: prompt tokens served from the prefix cache at admission (KV rows
    #: restored instead of prefilled); ``prefill_pos`` starts here
    cached_prefix_tokens: int = 0

    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)

    # speculation accounting
    drafted_tokens: int = 0
    accepted_tokens: int = 0

    #: caller-owned tags the scheduler carries and never reads (the RLHF
    #: loop's rollout index, ``rlhf_idx``)
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    @property
    def total_tokens(self) -> int:
        """Worst-case KV footprint in tokens (admission reserves this)."""
        return self.prompt_len + self.max_new_tokens

    @property
    def done(self) -> bool:
        return self.state in (FINISHED, REFUSED)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None or self.arrival_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def acceptance_rate(self) -> Optional[float]:
        if self.drafted_tokens == 0:
            return None
        return self.accepted_tokens / self.drafted_tokens

    def record_token(self, token: int, now: float) -> None:
        if not self.output:
            self.first_token_time = now
        self.output.append(int(token))
        self.token_times.append(now)

    def stats(self) -> dict:
        out = {"request_id": self.request_id, "state": self.state,
               "prompt_len": self.prompt_len, "new_tokens": len(self.output),
               "cached_prefix_tokens": self.cached_prefix_tokens}
        if self.ttft is not None:
            out["ttft"] = self.ttft
        if self.finish_time is not None and self.arrival_time is not None:
            out["latency"] = self.finish_time - self.arrival_time
        if self.drafted_tokens:
            out["drafted"] = self.drafted_tokens
            out["accepted"] = self.accepted_tokens
            out["acceptance_rate"] = self.acceptance_rate
        if self.refuse_reason:
            out["refuse_reason"] = self.refuse_reason
        return out
