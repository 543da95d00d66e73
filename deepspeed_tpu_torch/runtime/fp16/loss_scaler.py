"""The overflow guard (the part of ``deepspeed_tpu/runtime/fp16/loss_scaler.py``
that does not need fp16): :class:`OverflowWatcher` and :class:`OverflowAbort`.

The engine skips the update of a step whose gradients are not finite
(``runtime/engine.py`` ``step``). The watcher turns the stream of those
per-step flags into monitor events and, under
``resilience.max_consecutive_overflows``, into an abort. ``LossScaleState``
and dynamic loss scaling wait for fp16 training.
"""


class OverflowAbort(RuntimeError):
    """Raised by :class:`OverflowWatcher` when a run skips
    ``max_consecutive_overflows`` updates in a row: persistently non-finite
    gradients mean the run is poisoned (a bad data shard, diverged
    parameters, a numerics fault), and failing fast beats skipping for
    ever."""


class OverflowWatcher:
    """Host-side record of the engine's overflow skips: each step's flag is
    fed to :meth:`record`, which returns monitor events
    (``Train/loss_scale_cut`` when a loss scale dropped,
    ``Train/consecutive_overflow_skips`` tracking the streak) and raises
    :class:`OverflowAbort` when the streak reaches ``abort_after`` (0: never)."""

    def __init__(self, abort_after: int = 0):
        self.abort_after = int(abort_after)
        self.consecutive = 0
        self.longest_streak = 0
        self.total_skipped = 0
        self._last_scale = None

    def record(self, step: int, overflow: bool, loss_scale=None):
        """Feed one (step, overflow, post-step loss_scale); returns its
        monitor events. Raises :class:`OverflowAbort` when the streak
        reaches the guard."""
        events = []
        scale = float(loss_scale) if loss_scale is not None else None
        if overflow:
            self.consecutive += 1
            self.total_skipped += 1
            self.longest_streak = max(self.longest_streak, self.consecutive)
            events.append(("Train/consecutive_overflow_skips", self.consecutive, step))
            if scale is not None and self._last_scale is not None and scale < self._last_scale:
                events.append(("Train/loss_scale_cut", scale, step))
        else:
            if self.consecutive:
                # close the streak, so that a dashboard shows the recovery
                events.append(("Train/consecutive_overflow_skips", 0, step))
            self.consecutive = 0
        if scale is not None:
            self._last_scale = scale
        if self.abort_after and self.consecutive >= self.abort_after:
            raise OverflowAbort(
                f"{self.consecutive} consecutive overflow-skipped steps (through step "
                f"{step}); gradients are persistently non-finite"
                + (f", loss scale {scale}" if scale is not None else "")
                + f" — aborting per resilience.max_consecutive_overflows={self.abort_after}")
        return events
