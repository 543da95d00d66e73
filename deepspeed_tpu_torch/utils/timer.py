"""Wall-clock timers of the training engine's ``wall_clock_breakdown``
(counterpart of the part of ``deepspeed_tpu/utils/timer.py`` that the
engine uses: :class:`SynchronizedWallClockTimer` and :class:`NoopTimer`).

On a CUDA device a timer brackets its interval with two CUDA events on the
current stream, so starting and stopping it queue work instead of draining
the card; the interval is read (one wait on the stop event) when
``elapsed`` asks for it. On the CPU it reads the host clock, as JAX's does
after a device sync.
"""

import logging
import time
from typing import Optional

import torch

logger = logging.getLogger(__name__)

TRAIN_BATCH_TIMER = "train_batch"


class SynchronizedWallClockTimer:
    """Named timers, each of which sums its start/stop intervals."""

    class Timer:

        def __init__(self, name: str, device: torch.device):
            self.name_ = name
            self.device = device
            self.started_ = False
            self.elapsed_ = 0.0  # seconds of the closed intervals
            self.records = []
            self._open = None  # the start event or host time of the open interval
            self._pending = []  # closed CUDA intervals not yet read: (start, stop, record)

        def _cuda(self) -> bool:
            return self.device.type == "cuda"

        def start(self):
            assert not self.started_, f"{self.name_} timer has already been started"
            if self._cuda():
                self._open = torch.cuda.Event(enable_timing=True)
                self._open.record(torch.cuda.current_stream(self.device))
            else:
                self._open = time.perf_counter()
            self.started_ = True

        def stop(self, reset=False, record=False):
            assert self.started_, "timer is not started"
            if self._cuda():
                end = torch.cuda.Event(enable_timing=True)
                end.record(torch.cuda.current_stream(self.device))
                if reset:
                    self.elapsed_ = 0.0
                    self._pending = []
                self._pending.append((self._open, end, record))
            else:
                elapsed = time.perf_counter() - self._open
                self.elapsed_ = elapsed if reset else self.elapsed_ + elapsed
                if record:
                    self.records.append(self.elapsed_)
            self.started_ = False

        def _settle(self):
            """Read the closed CUDA intervals into ``elapsed_`` (a wait on
            the last stop event)."""
            for start, end, record in self._pending:
                end.synchronize()
                self.elapsed_ += start.elapsed_time(end) / 1000.0
                if record:
                    self.records.append(self.elapsed_)
            self._pending = []

        def reset(self):
            self.started_ = False
            self.elapsed_ = 0.0
            self.records = []
            self._pending = []

        def elapsed(self, reset=True) -> float:
            """Seconds summed over the intervals (an open one is closed and
            reopened around the read)."""
            started = self.started_
            if started:
                self.stop()
            self._settle()
            elapsed = self.elapsed_
            if reset:
                self.reset()
            if started:
                self.start()
            return elapsed

        def mean(self) -> float:
            self._settle()
            return sum(self.records) / len(self.records) if self.records else 0.0

    def __init__(self, device: Optional[torch.device] = None):
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.timers = {}

    def get_timers(self):
        return self.timers

    def __call__(self, name: str) -> "SynchronizedWallClockTimer.Timer":
        if name not in self.timers:
            self.timers[name] = self.Timer(name, self.device)
        return self.timers[name]

    def memory_usage(self) -> str:
        if self.device.type != "cuda":
            return "DeviceMem: n/a"
        alloc = torch.cuda.memory_allocated(self.device) / 1024**3
        peak = torch.cuda.max_memory_allocated(self.device) / 1024**3
        return f"DeviceMem: {alloc:.2f} GB in use, {peak:.2f} GB peak"

    def log(self, names, normalizer=1.0, reset=True, memory_breakdown=False, ranks=None) -> str:
        """Log (and return) ``time (ms) | name: ms ...`` over ``names``."""
        assert normalizer > 0.0
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed_time = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                string += f" | {name}: {elapsed_time:.2f}"
        if memory_breakdown:
            string += " | " + self.memory_usage()
        logger.info(string)
        return string

    def get_mean(self, names, normalizer=1.0, reset=True) -> dict:
        assert normalizer > 0.0
        return {name: self.timers[name].mean() * 1000.0 / normalizer
                for name in names if name in self.timers}


class NoopTimer:
    """The timers of an engine without ``wall_clock_breakdown``."""

    class Timer:

        def start(self):
            ...

        def reset(self):
            ...

        def stop(self, **kwargs):
            ...

        def elapsed(self, **kwargs):
            return 0

        def mean(self):
            return 0

    def __init__(self):
        self.timer = self.Timer()

    def __call__(self, name):
        return self.timer

    def get_timers(self):
        return {}

    def log(self, names, normalizer=1.0, reset=True, memory_breakdown=False, ranks=None):
        ...

    def get_mean(self, names, normalizer=1.0, reset=True):
        ...
