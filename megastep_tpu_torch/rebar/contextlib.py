"""Context managers usable from both ``with`` and ``async with``.

A copy of :mod:`megastep_tpu.rebar.contextlib` (the JAX package's module,
which the port does not import): the async protocol delegates to the sync one,
since the managed bodies (log and stat writer installation) are synchronous
either way.
"""
from contextlib import contextmanager
from functools import wraps


class _DualProtocol:
    """Adapts one sync context manager to both protocols."""

    __slots__ = ('_cm',)

    def __init__(self, cm):
        self._cm = cm

    def __enter__(self):
        return self._cm.__enter__()

    def __exit__(self, exc_type, exc, tb):
        return self._cm.__exit__(exc_type, exc, tb)

    async def __aenter__(self):
        return self.__enter__()

    async def __aexit__(self, exc_type, exc, tb):
        return self.__exit__(exc_type, exc, tb)


def maybeasynccontextmanager(func):
    """Like :func:`contextlib.contextmanager`, but the result also supports
    ``async with`` (entering/exiting synchronously)."""
    sync = contextmanager(func)

    @wraps(func)
    def make(*args, **kwargs):
        return _DualProtocol(sync(*args, **kwargs))
    return make
