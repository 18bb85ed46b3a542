"""Preemption-safe shutdown for long training runs (copy of
``spec_tpu/utils/preemption.py``).

A SIGTERM (a preempted machine's grace window) or SIGINT becomes a
cooperative stop flag: the train loop finishes its step, writes a
checkpoint and returns, and ``--resume`` continues from that step.

Usage::

    with GracefulShutdown() as stop:
        for batch in loader:
            step(...)
            if stop.requested:
                save_checkpoint(...)
                break
"""

from __future__ import annotations

import signal


class GracefulShutdown:
    """Context manager latching SIGTERM/SIGINT into ``requested``.

    The first signal sets the flag; a second SIGINT raises
    KeyboardInterrupt. Previous handlers come back on exit. Outside the
    main thread no handler can be installed and the flag stays False.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._previous: dict = {}
        self.requested = False

    def _handler(self, signum, frame):
        if self.requested and signum == signal.SIGINT:
            raise KeyboardInterrupt
        self.requested = True
        print(f'[preemption] received {signal.Signals(signum).name}; '
              'finishing the current step and checkpointing '
              '(signal again to force-quit)')

    def __enter__(self):
        try:
            for s in self._signals:
                self._previous[s] = signal.signal(s, self._handler)
        except ValueError:   # not the main thread
            self._previous = {}
        return self

    def __exit__(self, *exc):
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        return False
