"""Host-side metric primitives: counters, gauges, fixed-bucket histograms
(counterpart of ``deepspeed_tpu/runtime/telemetry/metrics.py``).

The histogram is the shared latency type: fixed bucket boundaries chosen
at construction, so two histograms from different processes or windows
merge by adding counts. Everything is plain Python floats and lists:
recording costs microseconds and never a device sync.
"""

import bisect
import math
from typing import Dict, List, Optional, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_LATENCY_BOUNDS"]


def exponential_bounds(start: float, factor: float, count: int) -> List[float]:
    """``count`` bucket boundaries growing geometrically from ``start``."""
    assert start > 0 and factor > 1 and count > 0
    return [start * factor**i for i in range(count)]


#: default latency boundaries: 1 µs to ~18 minutes in x2 steps (31 bounds,
#: 32 buckets with the two open ends)
DEFAULT_LATENCY_BOUNDS = tuple(exponential_bounds(1e-6, 2.0, 31))


class Counter:
    """Monotonic count (events, bytes, retries)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram, mergeable across windows/processes.

    ``bounds[i]`` is the *upper* edge of bucket ``i``; the final bucket is
    open-ended. Percentiles interpolate linearly inside the landing
    bucket (clamped by the observed min/max), which is the standard
    fixed-bucket estimator — exact enough for p50/p99 reporting at the
    default ×2 boundary spacing.
    """

    __slots__ = ("bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, bounds: Optional[Sequence[float]] = None):
        self.bounds = tuple(bounds if bounds is not None else DEFAULT_LATENCY_BOUNDS)
        assert list(self.bounds) == sorted(self.bounds), "bounds must be ascending"
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.count += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    def merge(self, other: "Histogram") -> "Histogram":
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different bucket bounds")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def percentile(self, p: float) -> Optional[float]:
        """Estimated p-th percentile (``p`` in [0, 100]); None when empty."""
        if self.count == 0:
            return None
        rank = p / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else min(self.min, self.bounds[0])
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                lo, hi = max(lo, self.min), min(max(hi, lo), self.max)
                frac = (rank - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
        return self.max

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def snapshot(self) -> Dict:
        """Compact JSON-able summary; ``buckets`` is sparse ({index: n})."""
        if self.count == 0:
            return {"count": 0}
        return {"count": self.count,
                "sum": self.sum,
                "min": self.min,
                "max": self.max,
                "mean": self.mean,
                "p50": self.percentile(50),
                "p90": self.percentile(90),
                "p99": self.percentile(99),
                "buckets": {str(i): c for i, c in enumerate(self.counts) if c}}


class MetricsRegistry:
    """Named counters/gauges/histograms with one JSON-able snapshot."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str, bounds: Optional[Sequence[float]] = None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(bounds)
        return h

    def snapshot(self) -> Dict:
        out: Dict = {}
        if self._counters:
            out["counters"] = {k: c.value for k, c in self._counters.items()}
        if self._gauges:
            out["gauges"] = {k: g.value for k, g in self._gauges.items()
                             if g.value is not None}
        if self._histograms:
            out["histograms"] = {k: h.snapshot() for k, h in self._histograms.items()}
        return out
