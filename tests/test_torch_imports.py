"""The port stands alone: importing it pulls in neither jax nor the JAX package,
and its entry points never fall back to the CPU on their own."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import megastep_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'megastep_tpu', 'bs4', 'lxml'))
print(len(names))
print(','.join(bad))
print(','.join(names))
"""


def test_import_pulls_in_no_jax():
    env = {**os.environ, 'PYTHONPATH': str(ROOT)}
    out = subprocess.run([sys.executable, '-c', _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad, names = (out.stdout + '\n\n').split('\n')[:3]
    assert int(n) >= 15, out.stdout
    assert bad == '', f'importing the port pulled in {bad}'
    # The training stack's subpackages and the cubicasa pipeline are among the
    # modules imported.
    for name in ('models.agent', 'models.heads', 'models.lstm', 'models.transformer',
                 'models.hybrid', 'models.hybrid_reference',
                 'demo.learning', 'demo.train', 'rebar.fsm', 'perf.train_flagship',
                 'cubicasa', 'polygons', 'ragged', 'rebar.parallel', 'envs.minimal',
                 'rebar.contextlib', 'rebar.paths', 'rebar.numpy', 'rebar.stats.categories',
                 'rebar.stats.writing', 'rebar.stats.device', 'rebar.stats.reading',
                 'rebar.widgets', 'rebar.logging', 'rebar.interrupting', 'rebar.storing',
                 'parallel.checkpoint', 'plotting', 'rebar.recording', 'rebar.plots',
                 'parallel.mesh', 'parallel.host', 'parallel.scaling', 'rebar.processes',
                 'rebar.queuing'):
        assert f'megastep_tpu_torch.{name}' in names.split(','), name


_BLOCKED_PROBE = """
import importlib, sys, tempfile
for name in ('pandas', 'IPython', 'ipywidgets'):
    sys.modules[name] = None  # any import of them raises ImportError
import torch
torch.set_num_threads(1)
for name in ('rebar', 'rebar.stats', 'rebar.storing', 'parallel.checkpoint', 'demo.train'):
    importlib.import_module('megastep_tpu_torch.' + name)
from megastep_tpu_torch.rebar import fsm, numpy as rnumpy, paths, storing
from megastep_tpu_torch.parallel import checkpoint
train = importlib.import_module('megastep_tpu_torch.demo.train')
d = tempfile.mkdtemp()
paths.ROOT = d + '/traces'
carry, history = train.train(fsm.MatchCoin(8, device='cpu'), buffer_size=4, batch_size=16,
                             width=8, steps=2, run_name='blocked', full_checkpoint=d + '/ck',
                             checkpoint_every=1)
assert len(history) == 2 and checkpoint.latest_step(d + '/ck') == 2
assert storing.load('blocked')['agent']
print(len(rnumpy.Reader('blocked', 'stats').read()))
print(','.join(sorted(m for m in sys.modules if sys.modules[m] is not None and
                      m.split('.')[0] in ('pandas', 'IPython', 'ipywidgets', 'jax', 'megastep_tpu'))))
"""


def test_run_directory_needs_no_pandas_or_ipython(tmp_path):
    """The chip machine has no pandas, IPython or ipywidgets: with all three
    blocked, the rebar write side, stored weights, checkpoints and a MatchCoin
    ``train(run_name=..., full_checkpoint=...)`` import and run."""
    env = {**os.environ, 'PYTHONPATH': str(ROOT)}
    out = subprocess.run([sys.executable, '-c', _BLOCKED_PROBE], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    channels, loaded = out.stdout.splitlines()[-2:]
    assert int(channels) >= 14
    assert loaded == ''


_NO_PLOTTING_PROBE = """
import importlib, sys
for name in ('matplotlib', 'PIL', 'pandas', 'IPython'):
    sys.modules[name] = None  # any import of them raises ImportError
import numpy as np
import torch
torch.set_num_threads(1)
for name in ('plotting', 'rebar.recording', 'rebar.plots', 'demo'):
    importlib.import_module('megastep_tpu_torch.' + name)
from megastep_tpu_torch import floorplans
from megastep_tpu_torch.demo import demo
from megastep_tpu_torch.envs import Explorer
env = Explorer(2, geometries=floorplans.sample(2, seed=7), res=64, device='cpu')
state, world = env.reset(torch.zeros((2, 1), dtype=torch.int32))
snap = env.state(state, world, 1)
assert isinstance(snap.seen, np.ndarray) and snap.seen.shape == (int(env.core.scenery.tex_width[1]),)
assert isinstance(snap.core.scenery.lines, np.ndarray)
try:
    env.plot_state(snap)
except ImportError as e:
    print('error:', e)
else:
    raise AssertionError('plot_state drew without matplotlib')
from megastep_tpu_torch.rebar import recording
try:
    recording.ParallelEncoder(env.plot_state, N=1, backend='process')
except ImportError as e:
    assert 'matplotlib' in str(e), e
else:
    raise AssertionError('an encoder without matplotlib')
print('loaded:', ','.join(sorted(m for m in sys.modules if sys.modules[m] is not None and
                      m.split('.')[0] in ('matplotlib', 'PIL', 'pandas', 'IPython'))))
"""


def test_snapshots_need_no_matplotlib_pillow_or_pandas(tmp_path):
    """The card's machine may lack matplotlib and Pillow: with them, pandas and
    IPython blocked, the plotting, recording, plots and demo modules import and
    ``env.state`` snapshots an env on the CPU; ``plot_state`` and
    ``ParallelEncoder`` raise an ImportError that names matplotlib."""
    env = {**os.environ, 'PYTHONPATH': str(ROOT)}
    out = subprocess.run([sys.executable, '-c', _NO_PLOTTING_PROBE], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    error, loaded = out.stdout.splitlines()[-2:]
    assert error.startswith('error:') and 'matplotlib' in error, out.stdout
    assert loaded == 'loaded: ', out.stdout


_CUBICASA_PROBE = """
import sys
from megastep_tpu_torch import cubicasa
print(','.join(sorted(m for m in sys.modules if m.split('.')[0] in ('bs4', 'lxml'))))
"""


def test_cubicasa_needs_no_bs4_or_lxml():
    """The card's machine has neither bs4 nor lxml: the SVG conversion must not
    import them, not even where they are installed."""
    env = {**os.environ, 'PYTHONPATH': str(ROOT)}
    out = subprocess.run([sys.executable, '-c', _CUBICASA_PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ''
    from megastep_tpu_torch import cubicasa
    svg = (ROOT / 'tests' / 'fixtures' / 'cubicasa' / 'loft_d' / 'model.svg').read_text()
    assert len(cubicasa.svg_geometry('loft_d', svg).walls) == 28


def test_chip_smoke_imports_no_jax():
    """``chip_smoke.py`` (run on the card) imports nothing of JAX either."""
    src = (ROOT / 'chip_smoke.py').read_text()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (['import'], ['from']):
            assert not words[1].split('.')[0] in ('jax', 'flax', 'megastep_tpu'), line


def test_entry_points_need_a_device_choice_without_a_gpu():
    """With no GPU, an entry point called without ``device=`` raises rather than
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the default device is valid here')
    from megastep_tpu_torch import envs, scene, toys
    with pytest.raises(RuntimeError, match='no CUDA device'):
        envs.Explorer(4)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        envs.Minimal(4)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        scene.scenery([toys.box()], random=np.random.RandomState(0))
    assert scene.scenery([toys.box()], random=np.random.RandomState(0),
                         bake_fn=None, device='cpu').device.type == 'cpu'
    from megastep_tpu_torch.demo import train
    from megastep_tpu_torch.perf import train_flagship
    from megastep_tpu_torch.rebar import fsm
    with pytest.raises(RuntimeError, match='no CUDA device'):
        fsm.MatchCoin(4)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train(n_envs=4, steps=1)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_flagship.build(n_envs=4)
    assert fsm.MatchCoin(4, device='cpu').device.type == 'cpu'
