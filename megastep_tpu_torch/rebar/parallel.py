"""Executor sugar for host-side process/thread pools.

Counterpart of :mod:`megastep_tpu.rebar.parallel` (the reference
``rebar/parallel.py:10-99``), standard library only: a ``SerialExecutor`` you can
step through in a debugger, a ``VariableExecutor`` that switches between
serial/thread/process backends by name, and :func:`parallel` — submit-everything,
reraise-the-first-exception, cancel-the-rest sugar. Used by the cubicasa
geometry pipeline; device work never goes through here.

One difference from the JAX module: the 'process' backend spawns its workers
where that module's forks them. A fork of a process that has threads, as one
that uses CUDA does, can deadlock in the child. So a submitted function and its
arguments go to the workers by pickle, and the function must be importable by
its module path.
"""
import logging
import multiprocessing
from concurrent.futures import (FIRST_EXCEPTION, Future, ProcessPoolExecutor,
                                ThreadPoolExecutor, wait)
from contextlib import contextmanager

log = logging.getLogger(__name__)


class SerialExecutor:
    """Runs submissions immediately on the calling thread — debuggable and
    deterministic."""

    def __init__(self, *args, **kwargs):
        pass

    def submit(self, f, *args, **kwargs):
        fut = Future()
        try:
            fut.set_result(f(*args, **kwargs))
        except Exception as e:
            fut.set_exception(e)
        return fut

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def shutdown(self, wait=True, cancel_futures=False):
        pass


def spawned_pool(n_workers=None, **kwargs):
    """A ``ProcessPoolExecutor`` whose workers start as fresh interpreters."""
    return ProcessPoolExecutor(n_workers, mp_context=multiprocessing.get_context('spawn'),
                               **kwargs)


BACKENDS = {
    'serial': SerialExecutor,
    'thread': ThreadPoolExecutor,
    'process': spawned_pool}


class VariableExecutor:
    """An executor whose backend ('serial'/'thread'/'process') is chosen at
    construction."""

    def __init__(self, n_workers=None, backend='process', **kwargs):
        cls = BACKENDS[backend]
        self._executor = cls() if backend == 'serial' else cls(n_workers, **kwargs)

    def submit(self, *args, **kwargs):
        return self._executor.submit(*args, **kwargs)

    def __enter__(self):
        self._executor.__enter__()
        return self

    def __exit__(self, *exc):
        return self._executor.__exit__(*exc)

    def shutdown(self, **kwargs):
        self._executor.shutdown(**kwargs)


@contextmanager
def parallel(f, progress=True, **kwargs):
    """Context manager yielding a callable proxy for ``f``; exit waits on all
    submissions, re-raises the first failure, and cancels the rest.

    >>> with parallel(f) as p:
    ...     futures = {x: p(x) for x in xs}
    ...     results = p.wait(futures)
    """
    with VariableExecutor(**kwargs) as executor:
        futures = []

        def submit(*args, **kw):
            fut = executor.submit(f, *args, **kw)
            futures.append(fut)
            return fut

        def wait_all(tree):
            if isinstance(tree, dict):
                return type(tree)({k: wait_all(v) for k, v in tree.items()})
            if isinstance(tree, (list, tuple)):
                return type(tree)(wait_all(v) for v in tree)
            return tree.result()

        submit.wait = wait_all
        try:
            yield submit
            done, not_done = wait(futures, return_when=FIRST_EXCEPTION)
            for fut in done:
                exc = fut.exception()
                if exc is not None:
                    raise exc
        finally:
            for fut in futures:
                fut.cancel()
