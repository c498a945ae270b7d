"""Metric categories: each declares a row schema and a resample reduction.

A copy of :mod:`megastep_tpu.rebar.stats.categories`, with pandas imported
only inside the reductions, so that writing stats needs no pandas. A
:class:`Category` owns its on-disk row schema (field names + defaults — the
part that IS the file format and must match what writers record) and a ``reduce(df, **resample_kwargs)`` turning the stored frame into a display
series. Writers bind rows via :meth:`Category.row`; readers call
:meth:`Category.reduce`; categories without a reduction (raw sample streams) are
skipped by tabular resampling and consumed by plots directly.

Reduction semantics (what each category *means*):

========== ==============================================================
last       most recent value in the bucket
max        largest value in the bucket
mean       Σtotal / Σcount (a ratio of bucket means — robust to write rate)
std        standard deviation of values in the bucket
cumsum     running total of all values so far
timeaverage wall-clock-weighted mean (irregularly sampled gauges)
duty       fraction of wall-clock spent inside the timed section
rate       events per second of wall-clock
period     seconds of wall-clock per event
maxrate    events per second of *measured* duration (peak capability)
dist       raw sample stream (no tabular reduction; histogram consumers)
noisescale Σbatch-var / Σgrad-sq — the gradient-noise-scale estimator
========== ==============================================================
"""

REQUIRED = object()


class Category:
    """One metric category.

    :param schema: ordered ``{field: default}``; ``REQUIRED`` marks positional
        fields. This ordering is the on-disk record layout.
    :param reduce: ``f(df, **resample_kwargs) -> Series`` or None for raw streams.
    """

    def __init__(self, name, schema, reduce=None):
        self.name = name
        self.schema = dict(schema)
        self._reduce = reduce

    def row(self, *args, **kwargs):
        """Binds call args against the schema into one record dict (the
        writer-side counterpart of the reference's ``inspect.getcallargs``)."""
        fields = list(self.schema)
        if len(args) > len(fields):
            raise TypeError(f'{self.name} takes {len(fields)} fields, got {len(args)}')
        row = dict(zip(fields, args))
        for k, v in kwargs.items():
            if k not in self.schema:
                raise TypeError(f'{self.name} has no field {k!r}')
            if k in row:
                raise TypeError(f'{self.name} got duplicate field {k!r}')
            row[k] = v
        for f, default in self.schema.items():
            if f not in row:
                if default is REQUIRED:
                    raise TypeError(f'{self.name} missing required field {f!r}')
                row[f] = default
        return row

    @property
    def reducible(self):
        return self._reduce is not None

    def reduce(self, df, **kwargs):
        if self._reduce is None:
            raise ValueError(f'category {self.name!r} has no tabular reduction')
        return self._reduce(df, **kwargs)


def _bucket_seconds(raw_index, resampled):
    """Seconds per resample bucket, capped by the RAW samples' actual span —
    a run shorter than one bucket must be rated over the time it really
    covered, not a full, mostly-empty bucket."""
    import pandas as pd
    freq_s = pd.to_timedelta(resampled.index.freq).total_seconds()
    span = (raw_index[-1] - raw_index[0]).total_seconds()
    return min(freq_s, span or freq_s)


def _last(df, **kw):
    return df['x'].resample(**kw).last()


def _max(df, **kw):
    return df['x'].resample(**kw).max()


def _mean(df, **kw):
    r = df.resample(**kw)
    return r['total'].mean() / r['count'].mean()


def _std(df, **kw):
    return df['x'].resample(**kw).std()


def _cumsum(df, **kw):
    return df['total'].resample(**kw).sum().cumsum()


def _timeaverage(df, **kw):
    x = df['x'].sort_index()
    dt = x.index.to_series().diff().dt.total_seconds()
    weighted = (x * dt).resample(**kw).mean()
    return weighted / dt.resample(**kw).mean()


def _duty(df, **kw):
    busy = df['duration'].resample(**kw).sum()
    elapsed = busy.index.to_series().diff().dt.total_seconds()
    return busy / elapsed


def _rate(df, **kw):
    counts = df['count'].resample(**kw).sum()
    return counts / _bucket_seconds(df.index, counts)


def _period(df, **kw):
    counts = df['count'].resample(**kw).sum()
    return _bucket_seconds(df.index, counts) / counts


def _maxrate(df, **kw):
    r = df.resample(**kw)
    return r['count'].mean() / r['duration'].mean()


def _noisescale(df, **kw):
    r = df.resample(**kw)
    return r['S'].mean() / r['G2'].mean()


CATEGORIES = {c.name: c for c in [
    Category('last', {'x': REQUIRED}, _last),
    Category('max', {'x': REQUIRED}, _max),
    Category('mean', {'total': REQUIRED, 'count': 1}, _mean),
    Category('std', {'x': REQUIRED}, _std),
    Category('cumsum', {'total': 1}, _cumsum),
    Category('timeaverage', {'x': REQUIRED}, _timeaverage),
    Category('duty', {'duration': REQUIRED}, _duty),
    Category('maxrate', {'duration': REQUIRED, 'count': 1}, _maxrate),
    Category('rate', {'count': 1}, _rate),
    Category('period', {'count': 1}, _period),
    Category('dist', {'samples': REQUIRED, 'size': 10000}, None),
    Category('noisescale', {'S': REQUIRED, 'G2': REQUIRED, 'B': REQUIRED},
             _noisescale),
]}
