"""Preemption handling: checkpoint on SIGTERM (the port's copy of the
JAX package's ``training/preemption.py``).

Cloud hosts deliver SIGTERM with a grace window before eviction; this
module turns that signal into a save of the ``last`` checkpoint so
``train.resume`` continues the run exactly where it stopped.

    guard = PreemptionGuard.install()
    for epoch in ...:
        ...train...
        if guard.triggered:
            save_checkpoint(...); break

The handler only sets a flag — checkpointing from inside a signal
handler would re-enter the framework mid-step.  The epoch loop polls
the flag at step granularity and exits through the normal save path.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional

log = logging.getLogger("cst_captioning_torch.preemption")


class PreemptionGuard:
    """Latches SIGTERM (and optionally SIGINT) into a thread-safe flag."""

    _installed: Optional["PreemptionGuard"] = None

    def __init__(self):
        self._event = threading.Event()
        self._prev = {}

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def _handler(self, signum, frame):
        log.warning(
            "signal %s received — will checkpoint and stop at the next "
            "step boundary", signal.Signals(signum).name,
        )
        self._event.set()
        prev = self._prev.get(signum)
        if callable(prev):  # chain to any previously-installed handler
            prev(signum, frame)

    @classmethod
    def install(cls, signals=(signal.SIGTERM,)) -> "PreemptionGuard":
        """Idempotent: repeated installs return the same guard.  Only the
        main thread may set signal handlers; elsewhere returns a guard
        that never triggers (e.g. a Trainer built inside a worker)."""
        if cls._installed is not None:
            return cls._installed
        guard = cls()
        if threading.current_thread() is not threading.main_thread():
            log.info("not on the main thread — preemption guard inert")
            return guard
        for sig in signals:
            try:
                guard._prev[sig] = signal.signal(sig, guard._handler)
            except (ValueError, OSError) as e:
                log.info("cannot install handler for %s (%s)", sig, e)
        cls._installed = guard
        return guard

    @classmethod
    def _reset_for_tests(cls) -> None:
        if cls._installed is not None:
            for sig, prev in cls._installed._prev.items():
                try:
                    signal.signal(sig, prev)
                except (ValueError, OSError):
                    pass
        cls._installed = None
