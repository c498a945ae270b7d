"""The port's rebar run-directory layer (``megastep_tpu_torch.rebar``: paths,
the ``.npr`` streams, stats, logging, storing, widgets, interrupting,
contextlib, ``FSM.dataframe``) and the run directory of ``demo.train.train``,
against the JAX package's modules on the same inputs, on the CPU.

Tolerances: exact everywhere (file bytes, rows, channel names, errors), but
for the category reductions, which ``pd.testing.assert_series_equal`` holds at
its default rtol (1e-5), and ``FSM.dataframe``, held by
``pd.testing.assert_frame_equal`` at its default.
"""
import asyncio
import importlib
import os
import signal
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from megastep_tpu_torch.rebar import (contextlib as rcontextlib, fsm, interrupting,
                                      logging as rlogging, numpy as rnumpy, paths,
                                      stats, storing, widgets)
from megastep_tpu_torch.rebar.stats import categories, device, writing

# The module, not the ``train`` function its package exports under that name.
train = importlib.import_module('megastep_tpu_torch.demo.train')

torch.set_num_threads(1)

RUN = dict(buffer_size=4, batch_size=16, width=8)  # MatchCoin(8): 2 minibatches


@pytest.fixture
def root(tmp_path, monkeypatch):
    """Both packages' run directories under ``tmp_path``."""
    monkeypatch.setattr(paths, 'ROOT', str(tmp_path / 'traces'))
    try:
        from megastep_tpu.rebar import paths as jpaths
    except ImportError:
        pass
    else:
        monkeypatch.setattr(jpaths, 'ROOT', str(tmp_path / 'traces'))
    return tmp_path / 'traces'


@pytest.fixture(scope='module')
def jr():
    """The JAX package's rebar modules."""
    pytest.importorskip('jax')
    pytest.importorskip('pandas')
    from megastep_tpu.rebar import fsm as jfsm, numpy as jnumpy, paths as jpaths
    from megastep_tpu.rebar import stats as jstats
    from megastep_tpu.rebar.stats import categories as jcategories
    return SimpleNamespace(fsm=jfsm, numpy=jnumpy, paths=jpaths, stats=jstats,
                           categories=jcategories)


def _channels(run_name, numpy_module=rnumpy):
    """{channel: rows} of a run's stats, read with a package's ``.npr`` reader."""
    return {k: np.concatenate(v) for k, v in numpy_module.Reader(run_name, 'stats').read().items()}


# --- .npr streams ---------------------------------------------------------------

T0 = np.datetime64('2026-01-02T03:04:05')
ROWS = {
    'mean': [{'_time': T0, 'total': 2.5, 'count': 1}, {'_time': T0, 'total': -1e9, 'count': 7}],
    'mixed': [{'_time': T0, 'x': np.float32(.25), 'n': np.int32(-3), 'flag': True},
              {'_time': T0 + 1, 'x': np.float32(7.), 'n': np.int32(4), 'flag': False}],
    'wide-name': [{'_time': T0, 'a-rather-long-field-name-for-the-header': 1.0,
                   'b': np.uint8(9), 'c': np.float16(.5)}],
}


@pytest.mark.parametrize('case', sorted(ROWS))
def test_npr_bytes_equal_jax_and_each_reads_the_other(root, jr, case):
    mine = paths.path('npr', 'stats', f'mine/{case}').with_suffix('.npr')
    theirs = paths.path('npr', 'stats', f'theirs/{case}').with_suffix('.npr')
    w, jw = rnumpy.FileWriter(mine), jr.numpy.FileWriter(theirs)
    for row in ROWS[case]:
        w.write(row)
        jw.write(row)
    w.close()
    jw.close()
    assert mine.read_bytes() == theirs.read_bytes()
    header = rnumpy.header_bytes(rnumpy.rowtype(ROWS[case][0]))
    assert len(header) % rnumpy.ALIGN == 0
    want = np.array([tuple(r.values()) for r in ROWS[case]], rnumpy.rowtype(ROWS[case][0]))
    for reader in (rnumpy.FileReader(theirs), jr.numpy.FileReader(mine)):
        np.testing.assert_array_equal(reader.read(), want)
        assert len(reader.read()) == 0
        reader.close()
    # The multi-process readers merge both channels the same way.
    got, their = rnumpy.Reader('npr', 'stats').read(), jr.numpy.Reader('npr', 'stats').read()
    assert sorted(got) == sorted(their)
    for k in got:
        np.testing.assert_array_equal(np.concatenate(got[k]), np.concatenate(their[k]))


def test_npr_tail_leaves_a_frayed_row(root):
    p = paths.path('npr', 'stats', 'tail').with_suffix('.npr')
    w = rnumpy.FileWriter(p)
    w.write(ROWS['mean'][0])
    r = rnumpy.FileReader(p)
    assert len(r.read()) == 1
    row = rnumpy.pack(ROWS['mean'][1], rnumpy.rowtype(ROWS['mean'][1]))
    with p.open('ab') as f:
        f.write(row[:5])
    assert len(r.read()) == 0
    with p.open('ab') as f:
        f.write(row[5:])
    assert r.read()['count'].tolist() == [7]
    w.close()
    r.close()


# --- categories -------------------------------------------------------------------

def _frame(name, seed=0):
    import pandas as pd
    rng = np.random.RandomState(seed)
    n = 40
    index = pd.DatetimeIndex(T0 + np.sort(rng.randint(0, 300, n)).astype('timedelta64[s]'),
                             name='time')
    schema = categories.CATEGORIES[name].schema
    cols = {f: (rng.randint(1, 9, n) if f == 'count' else rng.rand(n) * 10) for f in schema}
    return pd.DataFrame(cols, index=index)


@pytest.mark.parametrize('name', sorted(c for c, v in categories.CATEGORIES.items()
                                        if v.reducible))
def test_category_reduction_equals_jax(jr, name):
    import pandas as pd
    df = _frame(name)
    theirs = jr.categories.CATEGORIES[name].reduce(df.copy(), rule='60s')
    mine = categories.CATEGORIES[name].reduce(df.copy(), rule='60s')
    pd.testing.assert_series_equal(mine, theirs)


def test_category_schemas_and_row_errors_match_jax(jr):
    theirs = jr.categories.CATEGORIES
    assert list(categories.CATEGORIES) == list(theirs)
    for name, cat in categories.CATEGORIES.items():
        assert list(cat.schema) == list(theirs[name].schema)
        assert ([v is categories.REQUIRED for v in cat.schema.values()]
                == [v is jr.categories.REQUIRED for v in theirs[name].schema.values()])
        assert cat.reducible == theirs[name].reducible
    calls = [((1., 2, 3), {}), ((1.,), {'bogus': 2}), ((1., 2), {'total': 3.}), ((), {})]
    for args, kwargs in calls:
        errors = []
        for cats in (categories.CATEGORIES, theirs):
            with pytest.raises(TypeError) as e:
                cats['mean'].row(*args, **kwargs)
            errors.append(str(e.value))
        assert errors[0] == errors[1]
    assert categories.CATEGORIES['mean'].row(3., count=2) == theirs['mean'].row(3., count=2)


# --- stats writing, defer and reading ---------------------------------------------------

def _record_all(values):
    stats.mean('loss', values['loss'], values['count'])
    stats.max('peak', x=values['peak'])
    stats.cumsum('count/traj', values['trajs'])
    stats.last('lr', 3e-4)
    stats.rate('sample-rate/actor', values['samples'])


def test_defer_records_equal_eager_with_one_host_copy_per_dtype(root, monkeypatch):
    copies = []

    def counted(flat):
        copies.append(flat.dtype)
        return flat.cpu()
    monkeypatch.setattr(writing, '_to_host', counted)
    values = dict(loss=torch.tensor(2.5), count=torch.tensor(3), peak=torch.tensor(7.25),
                  trajs=torch.tensor(4.), samples=torch.tensor(64))
    with stats.to_dir('eager'):
        _record_all(values)
    assert copies == []
    with stats.to_dir('deferred'):
        with stats.defer():
            _record_all(values)
            assert not paths.subdirectory('deferred', 'stats').exists()
    assert sorted(copies, key=str) == [torch.float32, torch.int64]
    eager, deferred = _channels('eager'), _channels('deferred')
    assert sorted(eager) == sorted(deferred)
    for k in eager:
        assert eager[k].dtype == deferred[k].dtype, k
        for f in eager[k].dtype.names[1:]:
            np.testing.assert_array_equal(eager[k][f], deferred[k][f])


def test_defer_walks_nested_dicts_and_kwargs(root):
    queue = [('mean', 'a', ({'x': torch.tensor([1., 2.]), 'y': [torch.tensor(3)]},),
              {'count': torch.tensor(5)})]
    (flushed,) = writing._flush(queue)
    (arg,), kwargs = flushed[2], flushed[3]
    assert arg['x'].tolist() == [1., 2.] and arg['y'][0].item() == 3
    assert writing.clean(kwargs['count']) == 5 and isinstance(writing.clean(kwargs['count']), int)
    assert writing.clean(np.float32(2.)) == 2.
    assert writing.clean(np.array(1.5)) == 1.5


def test_stats_rows_and_resample_equal_jax(root, jr):
    """The same records through both packages' writers give the same rows, and
    JAX's reader resamples the port's files as it does its own."""
    import pandas as pd
    import jax.numpy as jnp
    with stats.to_dir('mine'):
        with stats.defer():
            _record_all(dict(loss=torch.tensor(2.5), count=torch.tensor(3),
                             peak=torch.tensor(7.25), trajs=torch.tensor(4.),
                             samples=64))
    with jr.stats.to_dir('theirs'):
        with jr.stats.defer():
            jr.stats.mean('loss', jnp.float32(2.5), jnp.int32(3))
            jr.stats.max('peak', x=jnp.float32(7.25))
            jr.stats.cumsum('count/traj', jnp.float32(4.))
            jr.stats.last('lr', 3e-4)
            jr.stats.rate('sample-rate/actor', 64)
    mine, theirs = _channels('mine'), _channels('theirs', jr.numpy)
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        assert mine[k].dtype.names == theirs[k].dtype.names, k
        for f in mine[k].dtype.names[1:]:
            np.testing.assert_array_equal(mine[k][f], theirs[k][f])
    pd.testing.assert_frame_equal(stats.Reader('mine').resample('1s'),
                                  jr.stats.Reader('mine').resample('1s'))
    assert set(stats.arrays(run_name='mine')) == {tuple(k.split('/', 1)) for k in mine}
    np.testing.assert_allclose(stats.pandas('loss', run_name='mine')['total'].values, [2.5])


def test_stats_write_nothing_without_a_dir(root):
    stats.mean('nowhere', 1.)
    assert not root.exists()


# --- device vitals ----------------------------------------------------------------

def test_vitals_record_nothing_without_cuda(root, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setattr(device, '_last', -1e9)
    with stats.to_dir('no-cuda'):
        device.vitals(throttle=0)
        device.memory()
    assert _channels('no-cuda') == {}


def test_vitals_record_memory_share_with_a_stubbed_cuda(root, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    monkeypatch.setattr(torch.cuda, 'memory_allocated', lambda i=0: 25)
    monkeypatch.setattr(torch.cuda, 'max_memory_allocated', lambda i=0: 50)
    monkeypatch.setattr(torch.cuda, 'get_device_properties',
                        lambda i: SimpleNamespace(total_memory=100))
    monkeypatch.setattr(device, '_last', -1e9)
    with stats.to_dir('vitals'):
        device.vitals(throttle=0)
        device.vitals(throttle=3600)  # throttled: no second row
        device.memory(0)
    rows = _channels('vitals')
    assert sorted(rows) == ['max/device-memory/alloc/0', 'max/device-memory/peak/0',
                            'mean/device/memory/0']
    assert rows['mean/device/memory/0']['total'].tolist() == [25.]
    assert rows['max/device-memory/peak/0']['x'].tolist() == [.5]
    assert stats.gpu is device


# --- paths, storing ---------------------------------------------------------------

def test_paths_parse_and_resolve_equal_jax(root, jr):
    p = paths.path('run', 'stats', 'mean/x/y')
    assert p.parent.is_dir()
    assert paths.parse(p) == jr.paths.parse(p)
    info = paths.parse(p.with_suffix('.npr'))
    assert (info.run_name, info.group, info.channel, info.pid) == (
        'run', 'stats', 'mean/x/y', str(os.getpid()))
    time.sleep(.01)
    paths.path('later', 'logs')
    assert paths.resolve(-1) == jr.paths.resolve(-1) == 'later'
    assert paths.resolve(0) == 'run' and paths.resolve('named') == 'named'
    with pytest.raises(ValueError):
        paths.resolve(1.5)
    with pytest.raises(ValueError):
        paths.path('bad_name', 'stats')
    assert list(paths.runs().run_name) == ['run', 'later']
    assert paths.size('run', 'stats') == 0
    paths.clear('run', 'stats')
    assert not paths.subdirectory('run', 'stats').exists()


def test_storing_throttles_renames_and_loads_the_newest(root, monkeypatch):
    agent = torch.nn.Linear(3, 2)
    assert storing.store_latest('store', {'agent': agent, 'tree': {'w': np.arange(3)}})
    assert not storing.store_latest('store', {'agent': agent}, throttle=60)
    (path,) = paths.glob('store', 'storing', pattern='*')
    assert path.suffix == '.pt'

    # A write that fails leaves the stored file as it was.
    def broken(obj, f):
        open(f, 'wb').write(b'partial')
        raise OSError('disk full')
    with monkeypatch.context() as m, pytest.raises(OSError):
        m.setattr(torch, 'save', broken)
        storing.store_latest('store', {'agent': agent})

    out = storing.load('store')
    assert set(out) == {'agent', 'tree'}
    for k, v in agent.state_dict().items():
        assert torch.equal(out['agent'][k], v)
    assert out['tree']['w'].tolist() == [0, 1, 2]
    with torch.no_grad():
        agent.weight.add_(1)
    assert storing.store_latest('store', {'agent': agent}, throttle=0)
    assert torch.equal(storing.load(-1)['agent']['weight'], agent.weight.detach())
    with pytest.raises(FileNotFoundError):
        storing.load('store', procname='NoSuchProcess')


def test_stored_lists_a_runs_files(root):
    pytest.importorskip('pandas')
    storing.store_latest('store', {'w': torch.zeros(2)})
    frame = storing.stored('store')
    assert len(frame) == 1 and frame.procname[0] == 'MainProcess'
    assert frame.path[0].suffix == '.pt'


# --- logging, widgets, interrupting, contextlib ---------------------------------------

def test_logging_to_dir_and_reader_tail(root):
    log = rlogging.getLogger('port-logger')
    with rlogging.to_dir('logs'):
        log.info('line one')
        reader = rlogging.Reader('logs')
        assert [l for _, l in reader.read() if 'line one' in l]
        log.info('line two')
        lines = [l for _, l in reader.read()]
        assert any('line two' in l for l in lines) and not any('line one' in l for l in lines)
        reader.close()
    (f,) = paths.glob('logs', 'logs', pattern='*.txt')
    assert 'line two' in f.read_text()


def test_logging_from_dir_merges_to_stdout_and_ends_its_thread(root, capsys):
    before = threading.active_count()
    log = rlogging.getLogger('pump-test')
    with rlogging.via_dir('pump', widgets.Compositor()):
        log.info('pumped line one')
        assert threading.active_count() == before + 1
        log.info('pumped line two')
    assert threading.active_count() == before
    out = capsys.readouterr().out
    # Every line written before the exit was drained, with no wait for it.
    assert 'pumped line one' in out and 'pumped line two' in out
    assert f'MainProcess/#{os.getpid()}' in out


def test_widgets_console_pane_prints(capsys):
    pane = widgets.Compositor(lines=5).output()
    assert pane.lines == 5
    pane.refresh('hello pane')
    pane.close()
    assert capsys.readouterr().out == 'hello pane\n'


def test_interrupter_defers_and_escalates():
    """As ``tests/test_rebar_extra.py::test_interrupter_defers_and_escalates``."""
    with interrupting.interrupter() as interrupt:
        interrupt.check()
        os.kill(os.getpid(), signal.SIGINT)
        with pytest.raises(KeyboardInterrupt):
            interrupt.check()
        interrupt.check()
        os.kill(os.getpid(), signal.SIGINT)
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGINT)
    assert signal.getsignal(signal.SIGINT) != interrupt._on_signal


def test_maybeasync_context_both_protocols():
    events = []

    @rcontextlib.maybeasynccontextmanager
    def ctx(tag):
        events.append(f'enter-{tag}')
        try:
            yield tag
        finally:
            events.append(f'exit-{tag}')

    with ctx('sync') as v:
        assert v == 'sync'

    async def use():
        async with ctx('async') as v:
            assert v == 'async'
    asyncio.run(use())
    assert events == ['enter-sync', 'exit-sync', 'enter-async', 'exit-async']


def test_fsm_dataframe_equals_jax(jr):
    import pandas as pd
    pd.testing.assert_frame_equal(fsm.ObliviousCoin(4, device='cpu').dataframe(),
                                  jr.fsm.ObliviousCoin(4).dataframe())


# --- train()'s run directory ------------------------------------------------------------

@pytest.fixture(scope='module')
def jax_channels(tmp_path_factory, jr):
    """The stats channels of one JAX ``train()`` on MatchCoin(8)."""
    pytest.importorskip('flax')
    pytest.importorskip('optax')
    dt = importlib.import_module('megastep_tpu.demo.train')
    old = jr.paths.ROOT
    jr.paths.ROOT = str(tmp_path_factory.mktemp('jax') / 'traces')
    try:
        dt.train(env=jr.fsm.MatchCoin(8), steps=1, run_name='jax-run', **RUN)
        return set(jr.numpy.Reader('jax-run', 'stats').read())
    finally:
        jr.paths.ROOT = old


def test_train_writes_the_jax_channels_logs_and_weights(root, jax_channels):
    carry, history = train.train(fsm.MatchCoin(8, device='cpu'), steps=2, run_name='run', **RUN)
    rows = _channels('run')
    assert set(rows) == jax_channels
    assert {'rate/sample-rate/actor', 'mean/traj-reward/mean', 'mean/step-reward',
            'cumsum/count/traj', 'mean/opt/loss', 'mean/opt/kl_div', 'duty/duty/step',
            'duty/duty/store'} <= set(rows)
    assert all(len(r) == 2 for r in rows.values())
    assert rows['rate/sample-rate/actor']['count'].tolist() == [32, 32]
    np.testing.assert_array_equal(rows['mean/opt/loss']['total'],
                                  [m['loss'] for m in history])
    (log,) = paths.glob('run', 'logs', pattern='*.txt')
    assert 'step 0 done' in log.read_text() and 'step 1 done' in log.read_text()
    stored = storing.load('run')['agent']
    for k, v in carry.agent.state_dict().items():
        assert stored[k].shape == v.shape


def test_train_default_run_name_and_clear(root):
    env = fsm.MatchCoin(8, device='cpu')
    day = time.strftime('%Y-%m-%d ')
    train.train(env, steps=1, **RUN)
    (name,) = [p.name for p in root.iterdir()]
    assert name.startswith(day) and name.endswith(f' {type(env).__name__}')
    stale = paths.path('old', 'stats')
    stale.touch()
    train.train(env, steps=0, run_name='old', **RUN)
    assert not stale.exists()


def test_train_resume_loads_the_stored_parameters_bit_for_bit(root):
    carry, _ = train.train(fsm.MatchCoin(8, device='cpu'), steps=1, run_name='first', **RUN)
    stored = storing.load('first')['agent']
    resumed, _ = train.train(fsm.MatchCoin(8, device='cpu'), steps=0, run_name='second',
                             resume='first', **RUN)
    fresh, _ = train.train(fsm.MatchCoin(8, device='cpu'), steps=0, run_name='third', **RUN)
    state = resumed.agent.state_dict()
    assert set(state) == set(stored)
    assert all(torch.equal(state[k], stored[k]) for k in stored)
    assert not all(torch.equal(fresh.agent.state_dict()[k], stored[k]) for k in stored)


def test_train_profile_writes_a_trace(root):
    train.train(fsm.MatchCoin(8, device='cpu'), steps=2, run_name='prof', profile=0, **RUN)
    (trace,) = paths.subdirectory('prof', 'profile').iterdir()
    assert trace.suffix == '.json' and trace.stat().st_size > 0
    assert '"traceEvents"' in trace.read_text()


class _Signalling:
    """MatchCoin whose ``step`` sends SIGINTs: ``timer`` starts a
    ``threading.Timer`` on the first step; ``burst`` sends two at once on the
    ``at``-th step."""

    def __init__(self, env, timer=None, burst_at=None):
        self._env, self._timer, self._burst_at = env, timer, burst_at
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self._env, name)

    def step(self, *args):
        self.calls += 1
        if self.calls == 1 and self._timer is not None:
            self._timer = threading.Timer(self._timer, os.kill, (os.getpid(), signal.SIGINT))
            self._timer.start()
        if self.calls == self._burst_at:
            os.kill(os.getpid(), signal.SIGINT)
            os.kill(os.getpid(), signal.SIGINT)
        return self._env.step(*args)


def test_train_sigint_is_deferred_to_the_chunk_boundary(root):
    """A SIGINT from a timer during an open-ended run raises KeyboardInterrupt
    out of train() after a whole chunk, whose stats, weights and checkpoint
    are on disk, and after the log pump has stopped."""
    before = threading.active_count()
    env = _Signalling(fsm.MatchCoin(8, device='cpu'), timer=.2)
    with pytest.raises(KeyboardInterrupt):
        train.train(env, steps=None, run_name='sigint', full_checkpoint=str(root / 'ck'),
                    checkpoint_every=1, **RUN)
    env._timer.join(5)
    assert threading.active_count() == before
    chunks = env.calls // RUN['buffer_size']
    assert chunks >= 1 and env.calls == chunks * RUN['buffer_size']
    rows = _channels('sigint')
    assert all(len(r) == chunks for r in rows.values())
    text = paths.glob('sigint', 'logs', pattern='*.txt')[0].read_text()
    assert f'step {chunks - 1} done' in text and f'step {chunks} done' not in text
    from megastep_tpu_torch.parallel import checkpoint
    assert checkpoint.latest_step(root / 'ck') == chunks
    assert storing.load('sigint')['agent']


def test_train_second_sigint_raises_at_once(root):
    env = _Signalling(fsm.MatchCoin(8, device='cpu'), burst_at=6)
    with pytest.raises(KeyboardInterrupt):
        train.train(env, steps=None, run_name='escalate', **RUN)
    assert env.calls == 6
    rows = _channels('escalate')
    assert all(len(r) == 1 for r in rows.values())
