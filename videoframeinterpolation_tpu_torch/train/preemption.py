"""Graceful preemption (counterpart of ``videoframeinterpolation_tpu/train/preemption.py``).

A SIGTERM mid-epoch would kill a run wherever it stands and lose
everything since the last ``save_latest_freq`` checkpoint; cloud machines
deliver one shortly before they are taken away. :class:`PreemptionGuard`
turns SIGTERM (and optionally SIGINT) into a flag that the trainer polls
between steps: it finishes the step in flight, writes ``latest`` (the
whole TrainState) and returns, and ``--resume latest`` continues from
there. The guard chains a previously installed Python handler, so an
embedding framework keeps its own cleanup, but never ``SIG_DFL`` or
``SIG_IGN`` (chaining the default action would defeat the graceful path).
Standard library only.
"""

from __future__ import annotations

import signal
import threading

_CHAINABLE_EXCLUDED = (signal.SIG_DFL, signal.SIG_IGN, None)


class PreemptionGuard:
    """Cooperative SIGTERM-to-flag bridge for the training loop.

    Usage::

        guard = PreemptionGuard()
        with guard:
            for batch in loader:
                step(batch)
                if guard.preempted:
                    save_checkpoint(); break

    Args:
      signals: signal numbers to intercept. SIGTERM is what a preemption or
        maintenance event delivers; add ``signal.SIGINT`` to make
        Ctrl-C checkpoint-and-exit instead of raising KeyboardInterrupt.
    """

    def __init__(self, signals: tuple = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._flag = threading.Event()
        self._prev: dict = {}
        self._installed = False

    # -- signal plumbing ------------------------------------------------ #

    def _handler(self, signum, frame):
        self._flag.set()
        prev = self._prev.get(signum)
        if callable(prev) and prev not in _CHAINABLE_EXCLUDED:
            prev(signum, frame)

    def install(self) -> bool:
        """Install handlers. Returns False (and stays a no-op guard) when
        not on the main thread — ``signal.signal`` only works there."""
        if self._installed:
            return True
        try:
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._handler)
        except ValueError:  # not the main thread
            for s, prev in self._prev.items():
                signal.signal(s, prev)  # pragma: no cover (main-thread only)
            self._prev.clear()
            return False
        self._installed = True
        return True

    def uninstall(self) -> None:
        if not self._installed:
            return
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        self.install()
        return self

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- flag ------------------------------------------------------------ #

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def trip(self) -> None:
        """Set the flag directly (tests, or app-level preemption notices
        such as GCE metadata-server maintenance events)."""
        self._flag.set()
