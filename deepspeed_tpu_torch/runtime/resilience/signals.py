"""Preemption-safe signal handling (counterpart of
``deepspeed_tpu/runtime/resilience/signals.py``).

:class:`PreemptionGuard` turns SIGTERM/SIGINT into a flag (the handler
only sets it: no I/O, no CUDA call) that a loop honours at its next
boundary: the serving scheduler drains and returns
``DEFAULT_PREEMPT_EXIT_CODE``, so a supervisor reads preemption, not
success. The guard chains any handler installed before it.
"""

import logging
import signal
import threading
from typing import Optional, Sequence

logger = logging.getLogger(__name__)

#: "terminated by SIGTERM" (128 + 15): a supervisor must not read a
#: preempted run as a finished one
DEFAULT_PREEMPT_EXIT_CODE = 143


class PreemptionGuard:
    """Convert termination signals into a boundary request::

        guard = PreemptionGuard().install()
        ...
        if guard.requested:          # checked at each boundary
            sig = guard.consume()

    Signal handlers work only on the main thread; elsewhere ``install``
    logs and the guard fires only through :meth:`request`. A second SIGINT
    while a request is pending restores the previous handlers and raises
    ``KeyboardInterrupt`` at once."""

    def __init__(self, signals: Sequence[str] = ("SIGTERM", "SIGINT")):
        self.signal_names = [s if isinstance(s, str) else signal.Signals(s).name for s in signals]
        self._requested: Optional[str] = None
        self._previous = {}
        self.installed = False

    def _on_signal(self, signum, frame):
        if self._requested is not None and signum == signal.SIGINT:
            # the boundary never came: get out now
            self.uninstall()
            raise KeyboardInterrupt
        self._requested = signal.Signals(signum).name
        prev = self._previous.get(signum)
        # chain custom handlers only: default_int_handler would raise
        # KeyboardInterrupt here, mid-step
        if callable(prev) and prev is not signal.default_int_handler:
            prev(signum, frame)

    def install(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            logger.warning("PreemptionGuard: not on the main thread, signal handlers cannot be "
                           "installed; the guard fires only through request()")
            return self
        for name in self.signal_names:
            sig = getattr(signal, name)
            self._previous[sig] = signal.getsignal(sig)
            signal.signal(sig, self._on_signal)
        self.installed = True
        return self

    def uninstall(self) -> None:
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
        self._previous = {}
        self.installed = False

    @property
    def requested(self) -> bool:
        return self._requested is not None

    def request(self, name: str = "manual") -> None:
        """Programmatic trigger (tests, cooperative shutdown)."""
        self._requested = name

    def consume(self) -> Optional[str]:
        """Return and clear the pending request (the signal's name)."""
        name, self._requested = self._requested, None
        return name
