"""Live training dashboards.

Counterpart of :mod:`megastep_tpu.rebar.plots` (the reference
``rebar/plots.py:180-233``): a :class:`Stream` polls the run's stats reader
(:class:`~megastep_tpu_torch.rebar.stats.Reader`) and pushes the resampled
rows into an existing figure — matplotlib by default, Bokeh with notebook push
when Bokeh and IPython both import. ``view()`` loops a Stream; ``review()``
renders the current state once. matplotlib, Bokeh and pandas are imported only
inside the functions that draw or frame.
"""
import re
import time
from collections import defaultdict

from .stats import Reader
from .stats.reading import tdformat


def timegroups(df):
    """Groups stat columns into charts by their ``chart/label`` name split."""
    groups = defaultdict(list)
    for col in df.columns:
        m = re.match(r'^(.*?)/(.*)$', col)
        chart = m.group(1) if m else col
        groups[chart].append(col)
    return dict(groups)


def _td_axis(ax):
    """Formats a seconds x-axis as compact timedeltas (1m30s, 2h05m...)."""
    import datetime
    import matplotlib.ticker as mtick
    ax.xaxis.set_major_formatter(mtick.FuncFormatter(
        lambda x, _: tdformat(datetime.timedelta(seconds=max(x, 0)))))


class Stream:
    """An incrementally-updated stats dashboard.

    Each :meth:`update` re-resamples the run's stats and pushes the rows into
    the existing artists; the figure is rebuilt only when the column set
    changes (a new stat appearing mid-run).
    """

    def __init__(self, run_name=-1, prefix='', backend=None):
        self._reader = Reader(run_name, prefix)
        if backend is None:
            backend = 'bokeh' if self._bokeh_usable() else 'matplotlib'
        self._backend = backend
        self._columns = None
        self._drawn = 0
        self._fig = None

    @staticmethod
    def _bokeh_usable():
        try:
            import bokeh.io  # noqa: F401
            from IPython import get_ipython
            return get_ipython() is not None
        except ImportError:
            return False

    # -- matplotlib backend ------------------------------------------------
    def _mpl_build(self, df):
        import matplotlib.pyplot as plt
        groups = timegroups(df)
        n = max(len(groups), 1)
        cols = min(n, 3)
        rows = -(-n // cols)
        if self._fig is not None:
            plt.close(self._fig)
        self._fig, axes = plt.subplots(rows, cols, squeeze=False,
                                       figsize=(5 * cols, 2.5 * rows))
        axes = axes.flatten()
        self._lines = {}
        for ax, (chart, columns) in zip(axes, groups.items()):
            for col in columns:
                (line,) = ax.plot([], [], label=col.split('/', 1)[-1])
                self._lines[col] = line
            ax.set_title(chart, fontsize='small')
            ax.legend(fontsize='x-small')
            _td_axis(ax)
        for ax in axes[len(groups):]:
            ax.axis('off')
        self._fig.tight_layout()

    def _mpl_push(self, df):
        for col in df.columns:
            line = self._lines[col]
            series = df[col].dropna()
            line.set_data(series.index.total_seconds(), series.values)
            ax = line.axes
            ax.relim()
            ax.autoscale_view()
        self._fig.canvas.draw_idle()

    # -- bokeh backend -----------------------------------------------------
    def _bokeh_build(self, df):
        import bokeh.io as bio
        import bokeh.layouts as bol
        import bokeh.models as bom
        import bokeh.plotting as bop
        self._sources = {}
        figures = []
        for chart, columns in timegroups(df).items():
            f = bop.figure(title=chart, width=350, height=250)
            f.xaxis.formatter = bom.CustomJSTickFormatter(code="""
                var s = Math.max(tick, 0), h = Math.floor(s/3600);
                var m = Math.floor((s - 3600*h)/60), r = Math.floor(s % 60);
                return h ? h+'h'+('0'+m).slice(-2)+'m'
                         : (m ? m+'m'+('0'+r).slice(-2)+'s' : r+'s');""")
            for col in columns:
                src = bom.ColumnDataSource({'t': [], 'v': []})
                f.line('t', 'v', source=src, legend_label=col.split('/', 1)[-1])
                self._sources[col] = src
            figures.append(f)
        self._grid = bol.gridplot(
            [figures[i:i + 3] for i in range(0, len(figures), 3)])
        self._handle = bio.show(self._grid, notebook_handle=True)

    def _bokeh_push(self, df, new_from):
        import bokeh.io as bio
        new = df.iloc[new_from:]
        for col in df.columns:
            series = new[col].dropna()
            self._sources[col].stream(
                {'t': series.index.total_seconds(), 'v': series.values})
        bio.push_notebook(handle=self._handle)

    # ----------------------------------------------------------------------
    def update(self, rule='60s'):
        """One poll: resample, rebuild if the column set changed, then push
        the new rows. Returns the number of resampled rows currently shown.

        The bokeh backend streams append-only, so the still-open last bucket
        is held back until it's final — pushing it early would freeze each
        point at its first partial aggregate. matplotlib re-sets the full
        series each poll and shows the live partial bucket."""
        df = self._reader.resample(rule)
        if df.empty:
            return 0
        cols = tuple(df.columns)
        if cols != self._columns:
            self._columns = cols
            self._drawn = 0
            (self._bokeh_build if self._backend == 'bokeh'
             else self._mpl_build)(df)
        if self._backend == 'bokeh':
            closed = df.iloc[:-1]
            self._bokeh_push(closed, self._drawn)
            self._drawn = len(closed)
        else:
            self._mpl_push(df)
            self._drawn = len(df)
        return self._drawn

    def watch(self, rule='60s', interval=1., updates=None):
        """Polls forever (or ``updates`` times), sleeping ``interval`` between."""
        import matplotlib.pyplot as plt
        n = 0
        while updates is None or n < updates:
            self.update(rule)
            if self._backend == 'matplotlib' and self._fig is not None:
                plt.pause(interval)
            else:
                time.sleep(interval)
            n += 1


def view(run_name=-1, prefix='', rule='60s', interval=1., updates=None):
    """Live dashboard of a running run: builds a Stream and polls it."""
    stream = Stream(run_name, prefix)
    stream.watch(rule=rule, interval=interval, updates=updates)
    return stream


def review(run_name=-1, prefix='', rule='60s'):
    """Renders the current state of a (finished or running) run's stats once."""
    stream = Stream(run_name, prefix, backend='matplotlib')
    if not stream.update(rule=rule):
        raise ValueError('No stats found for this run')
    return stream._fig
