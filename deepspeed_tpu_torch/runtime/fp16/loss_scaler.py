"""Loss scaling for fp16 training and the overflow guard (counterpart of
``deepspeed_tpu/runtime/fp16/loss_scaler.py``).

:class:`LossScaleState` is the scaler's state (the scale, the good steps
since the last overflow or growth, the hysteresis left); the update from
:func:`create_loss_scaler` is JAX's rule (``loss_scaler.py:48-66``)
step for step: on an overflow the hysteresis is spent first and the scale
halves (to ``min_scale`` at least) only once it is exhausted; without one
the scale doubles every ``scale_window`` good steps, and the hysteresis
refills (each step, or only at a growth under ``consecutive_hysteresis``).
A static scale never moves. The state is plain Python numbers: the port's
step syncs on its overflow flag already, so the rule runs on the host.

The engine skips the update of a step whose gradients are not finite
(``runtime/engine.py`` ``step``): :func:`has_overflow` under fp16, a
non-finite norm otherwise. :class:`OverflowWatcher` turns the stream of
those per-step flags and post-step scales into monitor events and, under
``resilience.max_consecutive_overflows``, into an abort.
"""

from typing import Callable, Iterable, NamedTuple, Tuple

import torch

INITIAL_LOSS_SCALE = "init_scale"
SCALE_WINDOW = "scale_window"
DELAYED_SHIFT = "delayed_shift"
CONSECUTIVE_HYSTERESIS = "consecutive_hysteresis"
MIN_LOSS_SCALE = "min_scale"


class LossScaleState(NamedTuple):
    """The scaler's state (JAX's fields): the scale (an fp32 value), the
    consecutive overflow-free steps and the overflows still tolerated
    before a cut. A static scaler only reads ``loss_scale``."""
    loss_scale: float
    good_steps: int
    hysteresis: int


def _f32(x: float) -> float:
    """``x`` rounded to fp32, as JAX keeps the scale."""
    return float(torch.tensor(x, dtype=torch.float32))


def create_loss_scaler(static_loss_scale: float = 0.0,
                       init_scale: float = 2**16,
                       scale_window: int = 1000,
                       min_scale: float = 1.0,
                       delayed_shift: int = 2,
                       consecutive_hysteresis: bool = False
                       ) -> Tuple[LossScaleState, Callable[[LossScaleState, bool], LossScaleState]]:
    """``(initial state, update)``; ``update(state, overflow)`` gives the
    next state. ``static_loss_scale > 0`` is a static scale (JAX's
    ``CreateLossScaler`` rule: fp16 with ``loss_scale`` != 0)."""
    dynamic = static_loss_scale == 0.0
    state = LossScaleState(loss_scale=_f32(init_scale if dynamic else static_loss_scale),
                           good_steps=0, hysteresis=int(delayed_shift))

    def update(state: LossScaleState, overflow: bool) -> LossScaleState:
        if not dynamic:
            return state
        if overflow:
            cut = max(_f32(state.loss_scale / 2.0), min_scale)
            return LossScaleState(loss_scale=_f32(cut if state.hysteresis <= 1 else state.loss_scale),
                                  good_steps=0, hysteresis=max(state.hysteresis - 1, 0))
        good = state.good_steps + 1
        grow = good % scale_window == 0
        hyst = delayed_shift if (not consecutive_hysteresis or grow) else state.hysteresis
        return LossScaleState(loss_scale=_f32(state.loss_scale * 2.0 if grow else state.loss_scale),
                              good_steps=good, hysteresis=int(hyst))

    return state, update


def has_overflow(grads: Iterable[torch.Tensor]) -> bool:
    """Whether any gradient holds a non-finite value (JAX ``has_overflow``;
    one host sync for all of them)."""
    flags = [(~torch.isfinite(g)).any() for g in grads]
    if not flags:
        return False
    return bool(torch.stack(flags).any())


class OverflowAbort(RuntimeError):
    """Raised by :class:`OverflowWatcher` when a run skips
    ``max_consecutive_overflows`` updates in a row: persistently non-finite
    gradients mean the run is poisoned (a bad data shard, diverged
    parameters, a numerics fault), and failing fast beats skipping for
    ever while the loss scale grinds down to ``min_scale``."""


class OverflowWatcher:
    """Host-side record of the engine's overflow skips: each step's flag and
    post-step loss scale are fed to :meth:`record`, which returns monitor
    events (``Train/loss_scale_cut`` when the scale dropped,
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
