"""Shared retry and backoff policy for flaky infrastructure (the port's copy
of ``deepspeed_tpu/runtime/resilience/retry.py``).

Exponential backoff with deterministic jitter, a bounded attempt budget, a
failure classifier (so an evidence row carries ``compile_helper_500``
instead of a bare traceback) and a per-attempt history the caller logs.

It imports nothing above the standard library, so that a launcher-level
supervisor can use it without touching the device.
"""

import random
import time
from typing import Callable, List, Optional

# failure classes the classifier recognizes
COMPILE_HELPER_500 = "compile_helper_500"
CONNECTION_FLAKE = "connection_flake"
CHECKPOINT_CORRUPT = "checkpoint_corrupt"

_COMPILE_HELPER_MARKS = ("remote_compile", "tpu_compile_helper")
_CONNECTION_MARKS = ("connection refused", "connection reset", "broken pipe",
                     "timed out", "temporarily unavailable")


def classify_failure(exc: BaseException) -> Optional[str]:
    """Map an exception to a known failure class (None: unrecognized),
    matched on its type name and message."""
    text = f"{type(exc).__name__}: {exc}".lower()
    if any(m in text for m in _COMPILE_HELPER_MARKS) and ("http 5" in text or "500" in text):
        return COMPILE_HELPER_500
    if "checkpointcorrupt" in text:
        return CHECKPOINT_CORRUPT
    if any(m in text for m in _CONNECTION_MARKS):
        return CONNECTION_FLAKE
    return None


def is_transient(exc: BaseException) -> bool:
    """The default retry predicate: compile-helper 500s and connection
    flakes are worth another attempt; corruption and everything
    unrecognized are not."""
    return classify_failure(exc) in (COMPILE_HELPER_500, CONNECTION_FLAKE)


class RetryPolicy:
    """Bounded exponential backoff with jitter.

    ``delay(n) = min(max_delay, base_delay * multiplier**(n-1)) * (1 +
    jitter*u)`` with ``u ~ U[0,1)`` from a seedable stream: deterministic in
    tests, decorrelated in a fleet.

    Args:
        max_attempts: total attempts, the first included (1: no retry).
        retry_on: predicate deciding whether an exception is retried;
            other exceptions propagate at once.
        sleep: the wait (tests inject one; :func:`heartbeat_sleep` keeps a
            supervised process's heartbeat fresh while it waits).
        seed: seeds the jitter stream (None: nondeterministic).

    After ``call``, ``self.attempts`` holds one dict per failed attempt,
    ``{attempt, error, error_class, delay_s}``: the evidence row's payload.
    """

    def __init__(self, max_attempts: int = 3, base_delay: float = 1.0,
                 max_delay: float = 120.0, multiplier: float = 2.0,
                 jitter: float = 0.25,
                 retry_on: Callable[[BaseException], bool] = is_transient,
                 sleep: Callable[[float], None] = time.sleep,
                 seed: Optional[int] = None):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.retry_on = retry_on
        self._sleep = sleep
        self._rng = random.Random(seed)
        self.attempts: List[dict] = []

    def delay_for(self, failed_attempts: int) -> float:
        base = min(self.max_delay, self.base_delay * self.multiplier ** (failed_attempts - 1))
        return base * (1.0 + self.jitter * self._rng.random())

    def evidence(self) -> dict:
        """The attempt history so far as an evidence-row fragment (empty
        when the first attempt succeeded)."""
        if not self.attempts:
            return {}
        return {"retries": len(self.attempts),
                "retry_history": [dict(a) for a in self.attempts]}

    def call(self, fn: Callable, *args,
             before_attempt: Optional[Callable[[int, List[dict]], None]] = None, **kwargs):
        """Run ``fn`` under the policy. ``before_attempt(attempt_index,
        attempts_so_far)`` fires before every attempt, the first included."""
        self.attempts = []
        for attempt in range(1, self.max_attempts + 1):
            if before_attempt is not None:
                before_attempt(attempt, self.attempts)
            try:
                return fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 (classified, then re-raised or retried)
                record = {"attempt": attempt,
                          "error": f"{type(e).__name__}: {str(e)[:240]}",
                          "error_class": classify_failure(e)}
                retryable = self.retry_on(e) and attempt < self.max_attempts
                record["delay_s"] = round(self.delay_for(attempt), 2) if retryable else 0.0
                self.attempts.append(record)
                if not retryable:
                    raise
                self._sleep(record["delay_s"])
        raise AssertionError("unreachable")


def heartbeat_sleep(slice_s: float = 5.0):
    """A ``sleep`` for supervised tools: naps in slices and touches the
    elastic agent's heartbeat between them, so a long backoff under
    ``DSElasticAgent`` reads as alive and waiting, not hung."""
    def _sleep(total: float) -> None:
        from deepspeed_tpu_torch.elasticity.elastic_agent import touch_heartbeat
        remaining = float(total)
        while remaining > 0:
            nap = min(slice_s, remaining)
            time.sleep(nap)
            remaining -= nap
            touch_heartbeat()
    return _sleep
