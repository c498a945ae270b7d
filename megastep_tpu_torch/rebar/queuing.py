"""Actor/learner IPC queues with a deadlock-free shutdown protocol.

Counterpart of :mod:`megastep_tpu.rebar.queuing` (the reference
``rebar/queuing.py``), standard library only, with the same names and
behaviour: size-1 queues carrying an ``__END__`` sentinel, non-blocking
puts/gets, and a three-phase :func:`close` (keep draining your intakes while
trying to send ENDs, then wait for ENDs back, then wait for your outputs to
drain) so that no pair of processes can deadlock on full queues. One
END-protocol class runs over two transports: an in-process list (the serial,
debuggable backend) and a ``multiprocessing.JoinableQueue``.

Items cross processes by pickle. Copy a CUDA tensor to the host before putting
it: the queue does not share device memory.
"""
import asyncio
import logging
import multiprocessing as mp
import queue as queue_mod
import time
import traceback
from contextlib import asynccontextmanager

from ..dotdict import dotdict

log = logging.getLogger(__name__)

END = '__END__'


class _ListTransport:
    """In-process size-1 buffer (the debuggable serial backend)."""

    def __init__(self):
        self._items = []

    def try_push(self, item):
        if self._items:
            return False
        self._items.append(item)
        return True

    def try_pop(self):
        return self._items.pop(0) if self._items else None

    def drained(self, timeout=None):
        return not self._items


class _MpTransport:
    """A size-1 JoinableQueue, non-blocking on both ends. It comes from the
    spawn context, so that a spawned child (the only kind that is safe once
    CUDA is live) can take it; the JAX module's comes from the default one."""

    def __init__(self):
        self._q = mp.get_context('spawn').JoinableQueue(1)

    def try_push(self, item):
        try:
            self._q.put_nowait(item)
            return True
        except queue_mod.Full:
            return False

    def try_pop(self):
        try:
            item = self._q.get_nowait()
            self._q.task_done()
            return item
        except queue_mod.Empty:
            return None

    def drained(self, timeout=None):
        try:
            with self._q._cond:
                if not self._q._unfinished_tasks._semlock._is_zero():
                    self._q._cond.wait(timeout=timeout)
            return True
        except RuntimeError:
            return False


class Channel:
    """The END protocol over a transport: values flow until each side has put and
    seen one END sentinel."""

    def __init__(self, transport):
        self._transport = transport
        self._end_sent = False
        self._end_seen = False

    def put(self, item):
        """Non-blocking put; False if the queue is full. END/None are reserved."""
        if item is None or (isinstance(item, str) and item == END):
            raise ValueError(f'Tried to put sentinel value "{item}"')
        return self._transport.try_push(item)

    def get(self):
        """Non-blocking get; None if empty (or if the END marker arrived)."""
        item = self._transport.try_pop()
        if isinstance(item, str) and item == END:
            log.info('Got END')
            self._end_seen = True
            return None
        return item

    def put_end(self):
        """Tries to enqueue the END marker (at most once); True once it's sent."""
        if not self._end_sent and self._transport.try_push(END):
            log.info('Put END')
            self._end_sent = True
        return self._end_sent

    def get_end(self):
        """Drains one item and reports whether END has been seen yet."""
        self.get()
        return self._end_seen

    def join(self, timeout=None):
        """True when everything put has been consumed downstream."""
        return self._transport.drained(timeout)


class SerialQueue(Channel):
    def __init__(self):
        super().__init__(_ListTransport())


class MultiprocessQueue(Channel):
    def __init__(self):
        super().__init__(_MpTransport())


async def _settle(condition, deadline, on_timeout):
    """Polls a condition until it holds or the deadline passes (cooperatively
    yielding — close() may run inside a bigger event loop)."""
    while not condition():
        if time.time() > deadline:
            log.warning(on_timeout)
            return False
        await asyncio.sleep(0)
        time.sleep(.1)
    return True


async def close(intakes, outputs, timeout=5):
    """Three-phase shutdown: send ENDs downstream (draining intakes so no one is
    stuck on a full queue), collect ENDs from upstream, wait for outputs to
    drain."""
    deadline = time.time() + timeout
    log.info(f'Closing; draining intakes and waiting to send ENDs. {timeout}s timeout.')

    def ends_sent():
        for i in intakes:  # keep upstream unblocked while we try to send
            i.get()
        return all(o.put_end() for o in outputs)

    if not await _settle(ends_sent, deadline,
                         'Timed out while waiting to send ENDs'):
        return
    log.info('Sent ENDs to outputs; waiting to get ENDs from intakes')
    if not await _settle(lambda: all(i.get_end() for i in intakes), deadline,
                         'Timed out while waiting to get ENDs'):
        return
    log.info('Intakes emptied; waiting for outputs to drain')
    if not await _settle(lambda: all(o.join(.1) for o in outputs), deadline,
                         'Timed out while waiting to drain outputs'):
        return
    log.info('Outputs drained.')


def create(spec, serial=False):
    """Builds a tree of queues from a spec of names (role of reference
    ``queuing.py:171-178``)."""
    if isinstance(spec, dict):
        return dotdict({name: create(sub, serial) for name, sub in spec.items()})
    if isinstance(spec, (list, tuple)):
        return dotdict({name: create(name, serial) for name in spec})
    if isinstance(spec, str):
        return SerialQueue() if serial else MultiprocessQueue()
    raise ValueError(f"Can't handle {type(spec)}")


@asynccontextmanager
async def cleanup(intakes, outputs):
    as_list = lambda qs: [qs] if isinstance(qs, Channel) else qs  # noqa: E731
    try:
        yield
    except Exception:
        log.info(f'Got an exception, cleaning up queues:\n{traceback.format_exc()}')
        raise
    finally:
        await close(as_list(intakes), as_list(outputs))
