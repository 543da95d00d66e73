"""The autoscaler: a replica count from the ``serve_tick`` signals
(counterpart of ``deepspeed_tpu/inference/fleet/autoscaler.py``).

A pure decision core (:meth:`Autoscaler.decide`) over the per-replica
signal dicts the router caches from ``tick`` messages and the replicas
write as ``serve_tick`` JSONL, so a decision replays offline from the run
directories alone (``events.last_tick_signals``). The thresholds:

* **scale up** (+1) when the fleet is saturated: mean queue depth per
  replica above ``queue_high``, or the worst replica's TTFT p99 above
  ``ttft_p99_high`` (when set), or mean block-pool fragmentation above
  ``frag_tokens_high`` (admission starves on fragments, not capacity: more
  replicas add whole pools).
* **scale down** (-1) when the fleet is idle: nothing queued anywhere and
  mean slot occupancy below ``occupancy_low``, and only when the survivors
  could absorb the load (what is in flight fits N-1 replicas' slots).
* **hysteresis**: each direction has its own cooldown; a decision stamps
  the clock, and the opposite direction also waits (``flap_guard_s``), so
  a drain followed by a spike does not thrash.

The autoscaler only decides; acting on it (spawning a
``SubprocessReplica``, a SIGTERM that migrates the victim's work) is the
caller's, which keeps it testable under a simulated clock with no
processes.
"""

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from deepspeed_tpu_torch.inference.serving.events import last_tick_signals


@dataclasses.dataclass
class AutoscalePolicy:
    """The thresholds of :class:`Autoscaler` (the JAX package's defaults)."""

    min_replicas: int = 1
    max_replicas: int = 4
    #: mean queued requests per replica that means "saturated"
    queue_high: float = 4.0
    #: worst-replica TTFT p99 (seconds) that means "saturated"; None
    #: disables the latency trigger (CPU rigs: absolute numbers vary)
    ttft_p99_high: Optional[float] = None
    #: mean BlockPool fragmentation (tokens) that means admission is
    #: starving on fragments; None disables
    frag_tokens_high: Optional[float] = None
    #: mean in_flight/slots below which the fleet is "idle"
    occupancy_low: float = 0.25
    scale_up_cooldown_s: float = 5.0
    scale_down_cooldown_s: float = 30.0
    #: after any decision, the OPPOSITE direction waits at least this long
    flap_guard_s: float = 10.0


class Autoscaler:
    """Hysteretic replica-count decisions from aggregated tick signals."""

    def __init__(self, policy: Optional[AutoscalePolicy] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.policy = policy or AutoscalePolicy()
        self.clock = clock or time.monotonic
        self._last_up = float("-inf")
        self._last_down = float("-inf")
        self.last_reason = "no signals yet"
        self.decisions: List[dict] = []

    # -- aggregation ---------------------------------------------------
    @staticmethod
    def aggregate(signals_by_replica: Dict[str, Optional[dict]]) -> Optional[dict]:
        """Fleet-level view of the per-replica signal dicts; None until at
        least one replica has reported."""
        rows = [s for s in signals_by_replica.values() if s]
        if not rows:
            return None
        n = len(rows)
        ttfts = [s["ttft_p99"] for s in rows if s.get("ttft_p99") is not None]
        slots = sum(s.get("slots", 0) for s in rows)
        in_flight = sum(s.get("in_flight", 0) for s in rows)
        return {
            "replicas": n,
            "mean_queue_depth": sum(s.get("queue_depth", 0) for s in rows) / n,
            "total_in_flight": in_flight,
            "total_slots": slots,
            "occupancy": in_flight / slots if slots else 0.0,
            "worst_ttft_p99": max(ttfts) if ttfts else None,
            "mean_frag_tokens": sum(s.get("pool_fragmentation_tokens", 0)
                                    for s in rows) / n,
        }

    # -- decision ------------------------------------------------------
    def decide(self, signals_by_replica: Dict[str, Optional[dict]],
               now: Optional[float] = None) -> int:
        """+1, 0 or -1 replicas; the reason lands in ``last_reason`` and
        the decision log (``decisions``)."""
        p = self.policy
        now = self.clock() if now is None else now
        agg = self.aggregate(signals_by_replica)
        if agg is None:
            self.last_reason = "no signals yet"
            return 0
        n = agg["replicas"]

        saturated = []
        if agg["mean_queue_depth"] > p.queue_high:
            saturated.append(f"mean_queue {agg['mean_queue_depth']:.1f} "
                             f"> {p.queue_high}")
        if (p.ttft_p99_high is not None and agg["worst_ttft_p99"] is not None
                and agg["worst_ttft_p99"] > p.ttft_p99_high):
            saturated.append(f"ttft_p99 {agg['worst_ttft_p99']:.3f}s "
                             f"> {p.ttft_p99_high}s")
        if (p.frag_tokens_high is not None
                and agg["mean_frag_tokens"] > p.frag_tokens_high):
            saturated.append(f"frag {agg['mean_frag_tokens']:.0f} tok "
                             f"> {p.frag_tokens_high}")
        if saturated:
            if n >= p.max_replicas:
                self.last_reason = (f"saturated ({'; '.join(saturated)}) but "
                                    f"at max_replicas={p.max_replicas}")
                return 0
            if (now - self._last_up < p.scale_up_cooldown_s
                    or now - self._last_down < p.flap_guard_s):
                self.last_reason = "saturated but in cooldown"
                return 0
            self._last_up = now
            self.last_reason = "; ".join(saturated)
            self._log(now, +1, agg)
            return +1

        idle = (agg["mean_queue_depth"] == 0
                and agg["occupancy"] < p.occupancy_low)
        if idle and n > p.min_replicas:
            # survivors must absorb the in-flight load (migration target
            # capacity): N-1 replicas' slots must fit what's in flight
            survivor_slots = agg["total_slots"] - agg["total_slots"] // max(n, 1)
            if agg["total_in_flight"] > survivor_slots:
                self.last_reason = "idle but survivors could not absorb in-flight"
                return 0
            if (now - self._last_down < p.scale_down_cooldown_s
                    or now - self._last_up < p.flap_guard_s):
                self.last_reason = "idle but in cooldown"
                return 0
            self._last_down = now
            self.last_reason = (f"idle (occupancy {agg['occupancy']:.2f} "
                                f"< {p.occupancy_low}, queue empty)")
            self._log(now, -1, agg)
            return -1
        self.last_reason = "steady"
        return 0

    def _log(self, now: float, delta: int, agg: dict) -> None:
        self.decisions.append({"t": now, "delta": delta,
                               "reason": self.last_reason, **agg})

    # -- offline replay ------------------------------------------------
    @staticmethod
    def signals_from_telemetry(paths: Dict[str, str]) -> Dict[str, Optional[dict]]:
        """Per-replica signals from telemetry JSONL files (replica name →
        run file): the file-tailing deployment where the autoscaler has
        no pipe to the replicas, and the offline replay of any decision."""
        return {name: last_tick_signals(path) for name, path in paths.items()}
