"""Stat readers: npr streams → pandas, plus the live display thread.

A copy of :mod:`megastep_tpu.rebar.stats.reading`: a :class:`Reader` that
merges every process's ``stats`` channels and resamples each by its category's
reduction, and a notebook pane showing the latest values. Pandas is imported
only inside the functions that return or take frames; :meth:`Reader.arrays`
reads the rows as numpy.
"""
import threading
import time
import _thread
from contextlib import contextmanager

import numpy as np

from .. import numpy as rnumpy, paths, widgets
from ..logging import in_ipython, getLogger
from . import categories

log = getLogger(__name__)


def format(v):  # noqa: A001 — reference-parity name
    """Compact human formatting for a stat value (scalars, lists, dicts)."""
    if isinstance(v, float):
        return f'{v:.6g}'
    if isinstance(v, list):
        return ', '.join(map(format, v))
    if isinstance(v, dict):
        inner = ', '.join(f'{k}: {format(x)}' for k, x in v.items())
        return '{' + inner + '}'
    return str(v)


def tdformat(td):
    """60h03m12s-style rendering of a timedelta."""
    secs = int(td.total_seconds())
    h, rem = divmod(secs, 3600)
    m, s = divmod(rem, 60)
    if h:
        return f'{h}h{m:02d}m{s:02d}s'
    if m:
        return f'{m}m{s:02d}s'
    return f'{s}s'


def adaptive_rule(df):
    """A resample rule that keeps the plotted point count sane as a run ages."""
    span = (df.index[-1] - df.index[0]).total_seconds()
    for limit, rule in [(600, '15s'), (7200, '1min')]:
        if span < limit:
            return rule
    return '10min'


class Reader:
    """Reads and resamples a run's stats channels.

    Three stages: ``arrays`` ingests new rows into per-(category, field)
    histories; ``pandas`` frames them on their ``_time`` index; ``resample``
    applies each category's reduction on a common rule.
    """

    def __init__(self, run_name, prefix=''):
        self._source = rnumpy.Reader(run_name, 'stats')
        self._prefix = prefix
        self._history = {}

    def arrays(self):
        for channel, chunks in self._source.read().items():
            category, _, field = channel.partition('/')
            if field.startswith(self._prefix):
                seen = self._history.get((category, field))
                parts = ([seen] if seen is not None else []) + chunks
                self._history[category, field] = np.concatenate(parts)
        return dict(self._history)

    def pandas(self):
        import pandas as pd
        frames = {}
        for key, rows in self.arrays().items():
            frame = pd.DataFrame.from_records(rows, index='_time')
            frame.index.name = 'time'
            frames[key] = frame
        return frames

    def resample(self, rule='60s', **kwargs):
        import pandas as pd
        reduced = {}
        for (category, field), frame in self.pandas().items():
            spec = categories.CATEGORIES[category]
            if spec.reducible:
                reduced[field] = spec.reduce(frame, rule=rule, **kwargs)
        if not reduced:
            return pd.DataFrame(index=pd.TimedeltaIndex([], name='time'))
        table = pd.concat(reduced, axis=1)
        table.index = table.index - table.index[0]
        return table


def arrays(prefix='', run_name=-1):
    return Reader(run_name, prefix).arrays()


def pandas(name, run_name=-1):
    for frame in Reader(run_name, name).pandas().values():
        return frame
    raise KeyError(f"Couldn't find a statistic matching {name}")


def resample(prefix='', run_name=-1, rule='60s'):
    return Reader(run_name, prefix).resample(rule)


class StatsPane:
    """Renders the latest resampled values of a run into a widget pane."""

    def __init__(self, run_name, out, rule):
        import pandas as pd
        self._run_name = run_name
        self._reader = Reader(run_name)
        self._out = out
        self._rule = rule
        self._born = pd.Timestamp.now()

    def _body(self):
        table = self._reader.resample(rule=self._rule)
        if not len(table):
            return 'No stats yet'
        latest = table.ffill(limit=1).iloc[-1].to_dict()
        pad = max((len(str(k)) for k in latest), default=0) + 1
        return '\n'.join(f'{k:<{pad}s} {format(latest[k])}'
                         for k in sorted(latest))

    def refresh(self):
        import pandas as pd
        age = tdformat(pd.Timestamp.now() - self._born)
        mb = paths.size(self._run_name, 'stats')
        self._out.refresh(f'{self._run_name}: {age} old, {self._rule} rule, '
                          f'{mb:.0f}MB on disk\n\n{self._body()}')


def _pump(canceller, pane, throttle=1):
    try:
        due = time.time()
        while True:
            if time.time() > due:
                due += throttle
                pane.refresh()
            if canceller.is_set():
                return
            time.sleep(.1)
    except KeyboardInterrupt:
        log.info('Interrupting main')
        _thread.interrupt_main()


@contextmanager
def from_dir(run_name, compositor=None, rule='60s'):
    """Spawns the live stats pane thread while in a notebook; a no-op on consoles
    (role of reference ``reading.py:101-159``)."""
    if not in_ipython():
        log.info('No stats emitted in console mode')
        yield
        return
    pane = StatsPane(run_name, (compositor or widgets.Compositor()).output(), rule)
    canceller = threading.Event()
    thread = threading.Thread(target=_pump, args=(canceller, pane))
    thread.start()
    try:
        yield
    finally:
        canceller.set()
        thread.join(1)
        if thread.is_alive():
            log.error("Stat display thread won't die")
        else:
            log.info('Stat display thread cancelled')
