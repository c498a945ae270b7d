"""Deferred SIGINT handling for long device loops.

A copy of :mod:`megastep_tpu.rebar.interrupting`: while active, a first
Ctrl-C only records the request, and the loop polls :meth:`Interrupter.check`
at safe points (a chunk boundary, after the stats, weights and checkpoint are
written), where the KeyboardInterrupt is raised. A second Ctrl-C before the
next check raises at once, so a loop stuck inside one long call can still be
stopped from the keyboard.
"""
import logging
import signal

from .contextlib import maybeasynccontextmanager

log = logging.getLogger(__name__)


class Interrupter:
    """Counts SIGINTs between checks; see module docstring."""

    def __init__(self):
        self._pending = 0

    def _on_signal(self, signum, frame):
        self._pending += 1
        if self._pending == 1:
            log.info('interrupt requested; will raise at the next check()')
        else:
            log.warning('second interrupt; raising immediately')
            self._pending = 0
            raise KeyboardInterrupt()

    def check(self):
        """Raises KeyboardInterrupt here if Ctrl-C arrived since the last check."""
        if self._pending:
            self._pending = 0
            raise KeyboardInterrupt()


@maybeasynccontextmanager
def interrupter():
    """Installs deferred SIGINT handling for the block; yields the
    :class:`Interrupter` whose ``check()`` the loop should poll."""
    state = Interrupter()
    previous = signal.signal(signal.SIGINT, state._on_signal)
    try:
        yield state
    finally:
        signal.signal(signal.SIGINT, previous)
