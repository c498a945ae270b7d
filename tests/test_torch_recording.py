"""The port's recording, plots and ``demo()`` against the JAX package's, on the CPU.

- ``Encoder``: the GIF bytes from the same frames are equal to the JAX
  encoder's; ``html_tag``, ``_as_uint8`` and ``array``'s even crop are equal;
  ``_pick_backend`` falls through PyAV → ``ffmpeg`` → GIF in both, shown with
  blocked or stand-in imports and a patched ``shutil.which``.
- ``ParallelEncoder``: frames that workers finish out of order are encoded in
  submission order under 'thread' and 'serial', and once under 'process' with
  2 workers (spawned, drawing with Agg); the bytes equal the JAX ``Encoder``'s
  on the same frames in order.
- ``plots``: ``timegroups``; ``Stream.update``'s incremental rows and rebuild on
  a new column; ``review``'s figure holds the same data as the JAX one on the
  same stats files.
- ``demo()``: on Explorer at res 64 with an 8-wide agent (the JAX agent's
  parameters through ``interop``), ``test=True``, ``length=8``: the snapshot
  stream, ``decision.value`` included, equals JAX ``demo()``'s step for step
  (indices, masks and widths exact, floats allclose(rtol=1e-5, atol=1e-6)).
  The JAX stream is collected by replacing
  ``megastep_tpu.rebar.recording.ParallelEncoder`` in this test; the JAX env's
  reset/step and the agent's apply are jitted by wrappers here. The port's env
  gets the JAX demo's spawn draws. The default path, ``demo(run=...)`` with the
  stored weights of a ``tmp_path`` run, records a GIF.
"""
import matplotlib
matplotlib.use('Agg')

import importlib
import shutil
import sys
import time
import types
from io import BytesIO

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import matplotlib.pyplot as plt
from PIL import Image

from megastep_tpu import floorplans as jfloorplans, spaces as jspaces
from megastep_tpu.dotdict import dotdict as jdotdict
from megastep_tpu.envs import Explorer as JExplorer
from megastep_tpu.models import Agent as JAgent
from megastep_tpu.rebar import plots as jplots, recording as jrecording
from megastep_tpu_torch import cubicasa, floorplans, interop
from megastep_tpu_torch.arrdict import arrdict
from megastep_tpu_torch.demo import demo
from megastep_tpu_torch.envs import Explorer
from megastep_tpu_torch.models import Agent
from megastep_tpu_torch.rebar import paths, plots, recording, stats, storing

from test_torch_plotting import assert_same_tree

torch.set_num_threads(1)

RES, WIDTH, LENGTH, N, SEED, N_SPAWNS = 64, 8, 8, 2, 3, 100
DPI = 50


def _frames():
    rs = np.random.RandomState(0)
    return ([rs.rand(10, 12, 3) for _ in range(3)]                    # float in [0, 1]
            + [rs.randint(0, 256, (10, 12, 3)).astype(np.uint8)]     # uint8
            + [rs.randint(-20, 300, (10, 12, 3))])                   # int, clipped


def _encode(module, frames, fps=5):
    with module.Encoder(fps=fps) as enc:
        for f in frames:
            enc(f)
    return enc


@pytest.fixture
def gif_only(monkeypatch):
    """Neither PyAV nor ffmpeg, whatever this machine has."""
    monkeypatch.setitem(sys.modules, 'av', None)
    monkeypatch.setattr(shutil, 'which', lambda name: None)


def test_gif_bytes_equal_jax(gif_only):
    got, want = _encode(recording, _frames()), _encode(jrecording, _frames())
    assert got.mimetype == want.mimetype == 'gif'
    assert got.value == want.value
    assert Image.open(BytesIO(got.value)).n_frames == len(_frames())
    gray = [np.full((6, 8, 1), 40 * i, np.uint8) for i in range(3)]
    assert _encode(recording, gray).value == _encode(jrecording, gray).value


def test_html_tag_and_as_uint8_equal_jax(gif_only):
    for f in _frames():
        got, want = recording._as_uint8(f), jrecording._as_uint8(f)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    enc, jenc = _encode(recording, _frames()), _encode(jrecording, _frames())
    assert recording.html_tag(enc) == jrecording.html_tag(jenc)
    assert recording.html_tag(enc, height=30).startswith('<img style="height: 30px"')
    video = b'\x00\x01mp4 bytes'
    assert (recording.html_tag(video, height=40, mimetype='mp4')
            == jrecording.html_tag(video, height=40, mimetype='mp4'))


def test_array_crops_to_even_sizes_as_jax():
    with matplotlib.rc_context({'figure.dpi': 51}):
        shapes = []
        for module in (recording, jrecording):
            fig = plt.figure(figsize=(1.51, 1.13))
            fig.gca().plot([0, 1], [1, 0])
            shapes.append(module.array(fig))
            plt.close(fig)
    got, want = shapes
    assert got.shape[0] % 2 == 0 and got.shape[1] % 2 == 0 and got.shape[2] == 3
    np.testing.assert_array_equal(got, want)


def test_pick_backend_falls_through_as_jax(monkeypatch):
    names = lambda: (recording._pick_backend().__name__, jrecording._pick_backend().__name__)
    monkeypatch.setitem(sys.modules, 'av', types.ModuleType('av'))
    assert names() == ('_AvBackend', '_AvBackend')
    monkeypatch.setitem(sys.modules, 'av', None)
    monkeypatch.setattr(shutil, 'which', lambda name: f'/bin/{name}')
    assert names() == ('_FfmpegBackend', '_FfmpegBackend')
    monkeypatch.setattr(shutil, 'which', lambda name: None)
    assert names() == ('_GifBackend', '_GifBackend')


def _late_frame(i, delay):
    """Frame ``i`` after ``delay`` seconds: later frames finish first."""
    time.sleep(delay)
    return np.full((8, 10, 3), 20 * i, np.uint8)


@pytest.mark.parametrize('backend', ['thread', 'serial'])
def test_parallel_encoder_keeps_submission_order(gif_only, backend):
    n, workers = 6, 3
    with recording.ParallelEncoder(_late_frame, fps=5, N=workers, backend=backend) as enc:
        for i in range(n):
            enc(i, .02 * (n - i))
            assert len(enc._pending) <= workers
    want = _encode(jrecording, [_late_frame(i, 0) for i in range(n)])
    assert enc.mimetype == 'gif'
    assert enc.result() == want.value


def test_parallel_encoder_in_spawned_processes(explorer_snapshots, gif_only):
    """Two spawned workers plot Explorer snapshots with Agg; the video equals
    the serial one."""
    snaps = explorer_snapshots[:3]
    videos = {}
    for backend in ('process', 'serial'):
        with recording.ParallelEncoder(Explorer.plot_state, N=2, backend=backend) as enc:
            for snap in snaps:
                enc(snap)
        videos[backend] = enc.result()
    assert videos['process'] == videos['serial']
    assert Image.open(BytesIO(videos['process'])).n_frames == len(snaps)


def test_plots_stream_and_review_match_jax(tmp_path, monkeypatch):
    from megastep_tpu.rebar import paths as jpaths
    monkeypatch.setattr(paths, 'ROOT', str(tmp_path))
    monkeypatch.setattr(jpaths, 'ROOT', str(tmp_path))
    with stats.to_dir('stream'):
        for i in range(3):
            stats.mean('loss/total', 1. / (i + 1))
            stats.mean('loss/value', 2. / (i + 1))
        stream = plots.Stream('stream', backend='matplotlib')
        n0 = stream.update(rule='1s')
        assert n0 > 0
        fig0 = stream._fig
        pts0 = len(stream._lines['loss/total'].get_xdata())
        time.sleep(1.1)
        for i in range(3):
            stats.mean('loss/total', 2. / (i + 1))
        assert stream.update(rule='1s') >= n0
        assert stream._fig is fig0  # same columns: no rebuild
        assert len(stream._lines['loss/total'].get_xdata()) >= pts0
        stats.mean('reward/mean', 1.)
        stream.update(rule='1s')
        assert stream._fig is not fig0  # new column: rebuilt
        assert 'reward/mean' in stream._lines
        plt.close(stream._fig)

    df = stream._reader.resample('1s')
    groups = plots.timegroups(df)
    assert groups == jplots.timegroups(df)
    assert {k: sorted(v) for k, v in groups.items()} == {
        'loss': ['loss/total', 'loss/value'], 'reward': ['reward/mean']}
    fig, jfig = plots.review('stream', rule='1s'), jplots.review('stream', rule='1s')
    for ax, jax_ in zip(fig.axes, jfig.axes, strict=True):
        assert ax.get_title() == jax_.get_title()
        for line, jline in zip(ax.get_lines(), jax_.get_lines(), strict=True):
            assert line.get_label() == jline.get_label()
            np.testing.assert_array_equal(line.get_xdata(), jline.get_xdata())
            np.testing.assert_array_equal(line.get_ydata(), jline.get_ydata())
    plt.close(fig)
    plt.close(jfig)
    with pytest.raises(ValueError, match='No stats'):
        plots.review('empty')


# -- demo() ---------------------------------------------------------------------

class _JittedEnv:
    """The JAX env with its reset and step jitted (its demo() calls them eagerly)."""

    def __init__(self, env):
        self._env = env
        self.reset, self.step = jax.jit(env.reset), jax.jit(env.step)

    def __getattr__(self, name):
        return getattr(self._env, name)


class _JittedAgent:
    """The flax agent with demo()'s apply jitted."""

    def __init__(self, agent):
        self.initial_state = agent.initial_state
        self._apply = jax.jit(lambda v, w, s, key: agent.apply(
            v, w, s, key=key, sample=True, test=True, value=True))

    def apply(self, variables, world, state, key, sample, test, value):
        assert sample and test and value
        return self._apply(variables, world, state, key)


def _recorder(streams):
    """A ParallelEncoder stand-in that keeps the snapshots it is given."""
    class Recorder:
        def __init__(self, f, N=None, backend='process', fps=20):
            self.states = []
            streams.append(self.states)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def __call__(self, state):
            self.states.append(state)
    return Recorder


def _spaces():
    return (jdotdict(rgb=jspaces.MultiImage(1, 3, 1, RES), d=jspaces.MultiImage(1, 1, 1, RES),
               imu=jspaces.MultiVector(1, 3)), jspaces.MultiDiscrete(1, 7))


@pytest.fixture(scope='module')
def jax_demo():
    """JAX demo() on Explorer (N envs, res 64, no pooling) with an 8-wide agent:
    its params and its snapshot stream."""
    jenv = JExplorer(N, geometries=jfloorplans.sample(N, seed=7), res=RES, subsample=1,
                     fused=False, random=np.random.RandomState(12))
    jagent = JAgent(*_spaces(), width=WIDTH)
    world = jax.jit(jenv.reset)(jax.random.PRNGKey(0))[1]
    world = jax.tree_util.tree_map(lambda x: x[None], world)
    params = jax.jit(lambda k: jagent.init(k, world, jagent.initial_state(N), value=True))(
        jax.random.PRNGKey(1))['params']
    train = importlib.import_module('megastep_tpu.demo.train')
    streams = []
    mp = pytest.MonkeyPatch()
    mp.setattr(jrecording, 'ParallelEncoder', _recorder(streams))
    try:
        train.demo(length=LENGTH, env=_JittedEnv(jenv), agent=_JittedAgent(jagent),
                   params=params, d=1, seed=SEED)
    finally:
        mp.undo()
    [stream] = streams
    return jax.tree_util.tree_map(np.asarray, params), stream


def _jax_spawns():
    """The spawn draws of JAX demo()'s reset and steps, as the port takes them."""
    key = jax.random.PRNGKey(SEED)
    key, k = jax.random.split(key)
    keys = [k]
    for _ in range(LENGTH):
        key, _, k_env = jax.random.split(key, 3)
        keys.append(k_env)
    return [torch.tensor(np.asarray(jax.random.randint(k, (N, 1), 0, N_SPAWNS)))
            for k in keys]


class _Capture(recording.ParallelEncoder):
    """The port's encoder, also keeping the snapshots it is given."""
    streams = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.states = []
        self.streams.append(self.states)

    def __call__(self, state):
        self.states.append(state)
        super().__call__(state)


def _port_env():
    env = Explorer(N, geometries=floorplans.sample(N, seed=7), res=RES, subsample=1,
                   random=np.random.RandomState(12), device='cpu')
    draws = iter(_jax_spawns())
    reset, step = env.reset, env.step
    env.reset = lambda rng: reset(next(draws))
    env.step = lambda state, decision, rng: step(state, decision, next(draws))
    return env


@pytest.fixture(scope='module')
def port_demo(jax_demo):
    """The port's demo() on the same env, weights and spawn draws, encoding
    through the real (serial) ParallelEncoder."""
    params, _ = jax_demo
    env = _port_env()
    agent = interop.agent_params_from_numpy(
        params, Agent(env.obs_space, env.action_space, width=WIDTH))
    mp = pytest.MonkeyPatch()
    mp.setattr(recording, 'ParallelEncoder', _Capture)
    mp.setitem(sys.modules, 'av', None)
    mp.setattr(shutil, 'which', lambda name: None)
    _Capture.streams = []
    try:
        with matplotlib.rc_context({'figure.dpi': DPI}):
            encoder = demo(length=LENGTH, env=env,
                           agent=Agent(env.obs_space, env.action_space, width=WIDTH),
                           params=agent.state_dict(), d=1, seed=SEED, backend='serial')
    finally:
        mp.undo()
    [stream] = _Capture.streams
    return encoder, stream


@pytest.fixture(scope='module')
def explorer_snapshots(port_demo):
    return port_demo[1]


def test_demo_stream_matches_jax(jax_demo, port_demo):
    _, want = jax_demo
    _, got = port_demo
    assert len(got) == len(want) == LENGTH
    for t, (mine, theirs) in enumerate(zip(got, want)):
        assert_same_tree(mine, theirs, f'step {t}')
        assert mine.decision.value.shape == (1,) and np.isfinite(mine.decision.value).all()
    assert any(s.seen.any() for s in got)


def test_demo_encodes_every_frame(port_demo):
    encoder, _ = port_demo
    assert encoder.mimetype == 'gif'
    video = encoder.result()
    assert Image.open(BytesIO(video)).n_frames == LENGTH


def test_demo_loads_the_stored_weights(tmp_path, monkeypatch, gif_only):
    """The default path: Explorer(d + 1) on cubicasa.sample (offline here: the
    procedural fallback), a 256-wide agent, weights from storing.load(run)."""
    def no_download(*args, **kwargs):
        raise RuntimeError('offline test: no download')
    monkeypatch.setattr(cubicasa, 'ROOT', tmp_path / 'cubicasa')
    monkeypatch.setattr(cubicasa, 'download', no_download)
    monkeypatch.setattr(paths, 'ROOT', str(tmp_path / 'traces'))
    probe = Explorer(1, geometries=floorplans.sample(1), device='cpu')
    stored = Agent(probe.obs_space, probe.action_space,
                   generator=torch.Generator().manual_seed(4))
    storing.store_latest('stored', dict(agent=stored))

    monkeypatch.setattr(recording, 'ParallelEncoder', _Capture)
    _Capture.streams = []
    with matplotlib.rc_context({'figure.dpi': DPI}):
        encoder = demo(run='stored', length=2, backend='serial', device='cpu')
    [seen] = _Capture.streams
    assert len(seen) == 2 and Image.open(BytesIO(encoder.result())).n_frames == 2
    assert seen[0].rgb.shape == (1, 3, 1, 64)
    with pytest.raises(RuntimeError, match='Missing key'):
        demo(length=1, env=probe, params={}, backend='serial')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            demo(run='stored', length=1, backend='serial')
