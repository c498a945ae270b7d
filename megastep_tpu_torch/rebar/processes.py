"""Process groups and supervised child processes.

Counterpart of :mod:`megastep_tpu.rebar.processes` (the reference
``rebar/processes.py``). The pieces map as:

  * the reference's NCCL process-group init (``processes.py:18-37``), which the
    JAX module replaces by ``jax.distributed``, is :func:`initialize` and
    :func:`processgroup` here, around ``torch.distributed``'s
    ``init_process_group`` and ``destroy_process_group``. The gradient
    all-reduce is the sharded train step's
    (:mod:`megastep_tpu_torch.parallel.mesh`);
  * ``consensus`` for coordinated cancellation (``processes.py:87-105``) is
    :func:`consensus`, an ``all_reduce(MIN)`` of a 0/1 tensor over the group;
  * the child supervisors (``processes.py:125-266``) are one :class:`Sentinel`
    over two "strand" kinds (an OS process, or a coroutine stepped in-process
    for debugging), with the JAX module's protocol: launch, check, and cancel
    with escalation.
"""
import asyncio
import inspect
import logging
import multiprocessing as mp
import time
from contextlib import contextmanager

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


def initialize(backend, init_method, world_size, rank):
    """Joins this process to the default ``torch.distributed`` group.

    :param backend: ``'nccl'`` (one GPU a rank) or ``'gloo'`` (CPU ranks, or
        ranks that share a GPU).
    :param init_method: the rendezvous, e.g. ``'tcp://localhost:<port>'`` or
        ``'file://<path>'``.
    """
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)


@contextmanager
def processgroup(*args, **kwargs):
    """:func:`initialize` for the ``with`` block's length; the group is
    destroyed on the way out, however the block ends."""
    initialize(*args, **kwargs)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _group_device():
    """Where a collective's tensor must live: the current GPU under NCCL, the
    host under gloo."""
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def consensus(b):
    """True only if every rank says True, so that either the whole group
    cancels or none of it does and no rank is left waiting in a collective.
    Without a process group, ``bool(b)``."""
    if not dist.is_initialized():
        return bool(b)
    t = torch.tensor(int(bool(b)), dtype=torch.int32, device=_group_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def cancel(canceller):
    """Group-safe cancellation check for a training loop (reference
    ``processes.py:92-105``)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        is_set = canceller.is_set()
        if is_set:
            log.info('Canceller set, trying to break')
        if consensus(is_set):
            log.info('Everyone has cancelled, breaking')
            return True
    elif canceller.is_set():
        log.info('Cancelled, breaking')
        return True
    return False


async def surrender():
    await asyncio.sleep(0)


class DeadStrand(Exception):
    """A supervised child died without being cancelled."""


def coroutine_runner(f, *args, **kwargs):
    co = f(*args, **kwargs)
    try:
        while True:
            co.send(None)
    except StopIteration:
        pass


def set_start_method():
    """Enforce spawn-family start methods: a fork is unsafe once CUDA is live
    (reference ``processes.py:72-85``)."""
    from multiprocessing import context
    ctx = context._default_context
    if ctx._actual_context is None:
        mp.set_start_method('spawn')
    else:
        assert ctx._actual_context._name in ('spawn', 'forkserver')


class _ProcessStrand:
    """A supervised child running as its own OS process."""

    #: seconds between graceful-cancellation polls
    pace = 1.

    def __init__(self, name, f, args, kwargs):
        self.name = name
        if inspect.iscoroutinefunction(f):
            f, args = coroutine_runner, (f, *args)
        self._proc = mp.Process(name=name, target=f, args=args, kwargs=kwargs)
        self._proc.start()

    def running(self):
        return self._proc.is_alive()

    def ensure_healthy(self):
        """A process that exited while supervised is a failure, clean or not."""
        if not self._proc.is_alive():
            raise DeadStrand(f'Process "{self.name}" died unexpectedly')

    def kill(self):
        self._proc.terminate()


class _CoroutineStrand:
    """A supervised child stepped in-process — the debuggable serial variant."""

    pace = 0.

    def __init__(self, name, f, args, kwargs):
        self.name = name
        self._co = f(*args, **kwargs)

    def running(self):
        try:
            self._co.send(None)
        except (RuntimeError, StopIteration):
            return False
        return True

    def ensure_healthy(self):
        """Stepping may finish cleanly (fine) or raise the child's own error."""
        try:
            self._co.send(None)
        except StopIteration:
            pass

    def kill(self):
        try:
            self._co.close()
        except RuntimeError:
            pass


class Sentinel:
    """Supervises children ("strands"): launch, dead-child detection via
    :meth:`check`, and cancel-with-escalation — ``wait`` polls for graceful exits
    and kills whatever survives the grace period. Covers the reference's
    ``ProcessSentinel``/``SerialSentinel`` pair (``processes.py:125-266``)."""

    strand_kind = _ProcessStrand

    def __init__(self, wait=15):
        self._grace = wait
        self._strands = []
        self._references = []
        self.canceller = mp.Event()

    @property
    def serial(self):
        return self.strand_kind is _CoroutineStrand

    def pin(self, obj):
        """Keeps an object (e.g. a queue) alive for as long as the children."""
        self._references.append(obj)

    def launch(self, f, *args, **kwargs):
        if self.canceller not in args and self.canceller not in kwargs.values():
            log.warning("Sentinel's canceller has not been passed to a launched process")
        base = f.__qualname__
        name = f'{base}-{sum(s.name.rsplit("-", 1)[0] == base for s in self._strands)}'
        self._strands.append(self.strand_kind(name, f, args, kwargs))
        log.info(f'Launched {name}')

    def check(self):
        """Raises (after cancelling everyone) if any child has died."""
        for strand in self._strands:
            try:
                strand.ensure_healthy()
            except Exception:
                log.info(f'"{strand.name}" died unexpectedly; cancelling')
                self.cancel()
                raise

    def wait(self):
        survivors = []
        for _ in range(int(self._grace)):
            survivors = [s for s in self._strands if s.running()]
            if not survivors:
                log.info('All children gracefully cancelled')
                break
            log.info('Waiting for cancellations: '
                     f'{", ".join(s.name for s in survivors)} still alive')
            time.sleep(self.strand_kind.pace)
        else:
            for s in survivors:
                log.info(f'Failed to cancel "{s.name}"; killing')
                s.kill()
        self._references = []

    def cancel(self):
        log.info('Setting canceller')
        self.canceller.set()
        self.wait()


class ProcessSentinel(Sentinel):
    strand_kind = _ProcessStrand

    def __init__(self, wait=15):
        set_start_method()
        super().__init__(wait)


class SerialSentinel(Sentinel):
    strand_kind = _CoroutineStrand


@contextmanager
def sentinel(serial=False):
    """Run supervised children; any exit path cancels them all cleanly
    (reference ``processes.py:249-266``)."""
    s = SerialSentinel() if serial else ProcessSentinel()
    try:
        yield s
    except KeyboardInterrupt:
        log.info('Got a keyboard interrupt, cancelling processes')
        s.cancel()
    except DeadStrand:
        raise
    except Exception:
        s.cancel()
        raise
    else:
        s.cancel()
