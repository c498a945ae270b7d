"""File-based multi-process logging.

Counterpart of :mod:`megastep_tpu.rebar.logging`: each process logs to its own
``logs/<procname>-<pid>.txt`` (:func:`to_dir`); a background pump tails every
process's file and merges the lines into stdout or a notebook pane
(:func:`from_dir`); :func:`via_dir` is both. When :func:`from_dir` exits, the
pump has read every line written before the exit and its thread has ended, so
nothing it prints can follow the caller's own output.
"""
import logging
import sys
import threading
import time
import traceback
import _thread
from collections import deque
from contextlib import contextmanager

from logging import getLogger  # re-export

from . import paths
from .contextlib import maybeasynccontextmanager

log = getLogger(__name__)

FORMAT = '%(asctime)s %(levelname)s %(name)s: %(message)s'
QUIET_EVICT_S = 120
#: Seconds between the pump's reads of the log files. Each read takes the
#: interpreter lock from a training loop whose host thread, launching kernels,
#: bounds it: at the JAX module's 10 ms the pump slowed the flagship config's
#: chunks on the card (``chip_smoke.py``'s ``run_dir_phase`` times a chunk
#: beside a pump at both rates).
POLL_S = .5


def configure():
    """Basic stdout logging config, applied once on first use."""
    if not getattr(configure, 'done', False):
        logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                            format=FORMAT, datefmt=r'%Y-%m-%d %H:%M:%S')
        logging.getLogger('parso').setLevel('WARN')
        configure.done = True


def in_ipython():
    try:
        __IPYTHON__  # noqa: F821
        return True
    except NameError:
        return False


@contextmanager
def handlers(*new_handlers):
    """Temporarily replaces the root logger's handlers (flushing and closing the
    new ones on the way out)."""
    root = logging.getLogger()
    saved = (root.handlers, root.level)
    root.handlers = list(new_handlers)
    # Handlers filter by their own level; make sure records reach them even if
    # some earlier config raised the root level.
    if root.level > logging.INFO:
        root.setLevel(logging.INFO)
    try:
        yield
    finally:
        root.setLevel(saved[1])
        for h in new_handlers:
            h.acquire()
            try:
                h.flush()
                h.close()
            except (OSError, ValueError):
                pass
            finally:
                h.release()
        root.handlers = saved[0]


@maybeasynccontextmanager
def to_dir(run_name):
    """Routes this process's root logger into its own run-dir file."""
    configure()
    sink = logging.FileHandler(
        paths.Run(run_name).file('logs').with_suffix('.txt'))
    sink.setLevel(logging.INFO)
    sink.setFormatter(logging.Formatter(fmt=FORMAT, datefmt=r'%H:%M:%S'))
    with handlers(sink):
        try:
            yield
        except Exception:
            log.info(f'Trace:\n{traceback.format_exc()}')
            raise


class Reader:
    """Tails all processes' log files of a run: each ``read()`` yields the
    (path, line) pairs appended anywhere since the last call."""

    def __init__(self, run_name):
        self._run = paths.Run(run_name)
        self._open = {}

    def read(self):
        for p in self._run.group('logs').glob('*.txt'):
            self._open.setdefault(p, p.open('r'))
        for p, f in self._open.items():
            while True:
                line = f.readline()
                if not line:
                    break
                yield p, line.rstrip('\n')

    def close(self):
        for f in self._open.values():
            f.close()
        self._open = {}


def _label(path):
    info = paths.parse(path)
    return f'{info.procname}/#{info.pid}'


class StdoutRenderer:
    """Console sink: prefix each merged line with its source process."""

    def emit(self, path, line):
        print(f'{_label(path)}: {line}')

    def close(self):
        pass


class IPythonRenderer:
    """Notebook sink: one pane holding a tail block per live source; sources
    quiet for :data:`QUIET_EVICT_S` fall out of the pane."""

    def __init__(self, compositor=None):
        from . import widgets
        self._pane = (compositor or widgets.Compositor()).output()
        self._sources = {}  # label -> (deque of lines, last-seen time)

    def emit(self, path, line):
        label = _label(path)
        if label not in self._sources:
            empty = deque([''] * self._pane.lines, maxlen=self._pane.lines)
            self._sources[label] = [empty, time.time()]
        self._sources[label][0].append(line)
        self._sources[label][1] = time.time()
        self._repaint()

    def _repaint(self):
        budget = max(self._pane.lines // (len(self._sources) + 2), 1)
        blocks = ('{}:\n{}'.format(label, '\n'.join(list(lines)[-budget:]))
                  for label, (lines, _) in self._sources.items())
        self._pane.refresh('\n\n'.join(blocks))
        now = time.time()
        self._sources = {label: entry for label, entry in self._sources.items()
                         if now - entry[1] <= QUIET_EVICT_S}

    def close(self):
        self._repaint()


class _Pump(threading.Thread):
    """Tail-and-render loop; a KeyboardInterrupt inside the thread is forwarded
    to the main thread and the pump keeps draining until stopped."""

    def __init__(self, reader, renderer):
        super().__init__(daemon=True)
        self._reader = reader
        self._renderer = renderer
        self._halt = threading.Event()

    def _drain_until_stopped(self):
        while True:
            # A full pass after the halt is seen, so that no line written
            # before stop() is left unread.
            halted = self._halt.is_set()
            for path, line in self._reader.read():
                self._renderer.emit(path, line)
            if halted:
                return
            self._halt.wait(POLL_S)

    def run(self):
        try:
            self._drain_until_stopped()
        except KeyboardInterrupt:
            log.info('Interrupting main')
            _thread.interrupt_main()
            self._drain_until_stopped()
        finally:
            self._reader.close()

    def stop(self, grace=.25, timeout=30):
        time.sleep(grace)  # let other processes' last lines land on disk
        self._halt.set()
        self.join(timeout)
        return not self.is_alive()


@contextmanager
def from_dir(run_name, compositor=None):
    """Spawns the tail-and-render pump for a run's logs."""
    renderer = IPythonRenderer(compositor) if in_ipython() else StdoutRenderer()
    with to_dir(run_name):
        pump = _Pump(Reader(run_name), renderer)
        pump.start()
        try:
            yield
        finally:
            log.info('Cancelling log forwarding thread')
            if pump.stop():
                log.info('Log forwarding thread cancelled')
            else:
                log.error("Logging thread won't die")


@contextmanager
def via_dir(run_name, compositor=None):
    with to_dir(run_name), from_dir(run_name, compositor):
        yield
