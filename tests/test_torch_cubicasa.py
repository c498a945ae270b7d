"""The port's cubicasa pipeline (``megastep_tpu_torch.cubicasa``, parsing with
the standard library's ElementTree) against the JAX package's (bs4 over lxml),
on the CPU.

Walls, masks and lights must be exactly equal on the five fixture plans and on
the crafted markup of ``tests/test_cubicasa_svg.py`` (tolerance: none); the
engine driven by a real plan picks the JAX package's lines, with distances and
screen at allclose(rtol=1e-5, atol=1e-6). Every test runs offline: ``ROOT`` is
a temporary directory and ``download`` raises, so neither a user's cache nor
``MEGASTEP_TPU_CUBICASA_AGREE`` changes what a test sees.
"""
import importlib
import os
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from megastep_tpu_torch import core, cubicasa, floorplans, scene
from megastep_tpu_torch.envs import Deathmatch, Explorer
from megastep_tpu_torch.rebar import parallel

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).parent / 'fixtures' / 'cubicasa'
PLANS = ('apartment_a', 'studio_b', 'rowhouse_c', 'loft_d', 'duplex_e')
#: Malformed markup that lxml's recovering parser reads and ElementTree rejects.
UNCLOSED = '<svg><g class="Wall"><polygon points="0,0 100,0 100,100"></g></svg>'


def _fixture(name):
    return (FIXTURES / name / 'model.svg').read_text()


def _offline(module, monkeypatch, root):
    def no_download(*args, **kwargs):
        raise RuntimeError('offline test: no download')
    monkeypatch.setattr(module, 'ROOT', Path(root))
    monkeypatch.setattr(module, 'download', no_download)


@pytest.fixture(autouse=True)
def offline(tmp_path, monkeypatch):
    _offline(cubicasa, monkeypatch, tmp_path)
    return tmp_path


@pytest.fixture(scope='module')
def jc():
    pytest.importorskip('bs4')                 # the JAX package's SVG parser
    return pytest.importorskip('megastep_tpu.cubicasa')


def _markup():
    """The five fixture plans and every crafted string of the JAX tests."""
    crafted = importlib.import_module('test_cubicasa_svg')
    return {**{n: _fixture(n) for n in PLANS},
            'APARTMENT_SVG': crafted.APARTMENT_SVG, 'RAILING_SVG': crafted.RAILING_SVG}


def _same_geometry(g, jg):
    assert g.id == jg.id and g.res == jg.res
    for k in ('walls', 'lights', 'masks'):
        assert g[k].shape == jg[k].shape and g[k].dtype == jg[k].dtype, k
        np.testing.assert_array_equal(g[k], jg[k], err_msg=k)


@pytest.mark.parametrize('name', PLANS + ('APARTMENT_SVG', 'RAILING_SVG'))
def test_parsing_matches_jax(jc, name):
    svg = _markup()[name]
    els, jels = cubicasa.svg_elements(svg), jc.svg_elements(svg)
    for k in ('walls', 'doors', 'spaces'):
        assert len(els[k]) == len(jels[k]), k
        for x, y in zip(els[k], jels[k]):
            np.testing.assert_array_equal(x, y)
    _same_geometry(cubicasa.svg_geometry(name, svg), jc.svg_geometry(name, svg))


def test_elementtree_rejects_what_lxml_recovers(jc):
    """The known difference (the module's docstring): a file lxml recovers
    from drops out of the port's dataset."""
    assert len(jc.svg_elements(UNCLOSED).walls) == 1
    with pytest.raises(Exception, match='mismatched tag'):
        cubicasa.svg_elements(UNCLOSED)
    assert cubicasa.safe_geometry('bad', UNCLOSED) is None


@pytest.mark.parametrize('backend', ['serial', 'thread', 'process'])
def test_parallel_matches_jax(backend):
    """``rebar.parallel`` on each backend gives the JAX module's results, in
    submission order, and its wait keeps the tree's shape."""
    jparallel = pytest.importorskip('megastep_tpu.rebar.parallel')
    got = []
    for m in (parallel, jparallel):
        with m.parallel(pow, backend=backend) as p:
            futs = {i: p(i, 3) for i in range(6)}
            got.append((p.wait(futs), p.wait([futs[1], (futs[2],)])))
    assert got[0] == got[1] == ({i: i ** 3 for i in range(6)}, [1, (8,)])


def test_parallel_reraises_the_first_failure():
    """As ``tests/test_rebar.py`` holds the JAX module: the serial executor runs
    at once, and a failed submission is raised on the way out."""
    with parallel.parallel(lambda x: x * 2, backend='serial') as p:
        futs = [p(i) for i in range(5)]
        assert [f.result() for f in futs] == [0, 2, 4, 6, 8]

    def boom(x):
        raise ValueError('boom')
    with pytest.raises(ValueError, match='boom'):
        with parallel.parallel(boom, backend='serial') as p:
            p(1)


def _zip(root, names, bad=True):
    with zipfile.ZipFile(root / 'cubicasa5k.zip', 'w') as z:
        for i, name in enumerate(names):
            z.writestr(f'cubicasa5k/plans/{i}/model.svg', _fixture(name))
        if bad:
            z.writestr(f'cubicasa5k/plans/{len(names)}/model.svg', '<svg></svg>')


def test_zip_to_cache_to_sample_matches_jax(jc, offline, monkeypatch):
    """The zip → cache → ``sample`` round trip, the bad entry skipped, beside
    the JAX package's own conversion of the same zip: the same geometries and
    the same picks."""
    _offline(jc, monkeypatch, offline)
    for m in (cubicasa, jc):
        monkeypatch.setattr(m, 'N_TEST', 2)
    _zip(offline, PLANS)

    geoms = cubicasa.geometry_data(backend='process')
    jgeoms = jc.geometry_data(backend='serial')
    assert len(geoms) == len(jgeoms) == 5      # the bad entry is skipped
    for g, jg in zip(geoms, jgeoms):
        _same_geometry(g, jg)
    assert cubicasa.cache_path() == offline / f'geometries-torch-v{cubicasa.CACHE_VERSION}.pkl.gz'
    assert cubicasa.cache_path().exists()
    assert (offline / f'geometries-v{jc.CACHE_VERSION}.pkl.gz').exists()

    (offline / 'cubicasa5k.zip').unlink()      # the cache alone serves from now on
    for g, again in zip(geoms, cubicasa.geometry_data()):
        _same_geometry(g, again)
    for split, n in (('training', 4), ('test', 3)):
        picks = cubicasa.sample(n, split, fallback=None)
        assert len(picks) == n
        for g, jg in zip(picks, jc.sample(n, split, fallback=None)):
            _same_geometry(g, jg)


def test_small_dataset_leaves_no_training_split(jc, offline, monkeypatch):
    """With no more plans than ``N_TEST`` the training split is empty, and both
    packages refuse to sample from it."""
    _offline(jc, monkeypatch, offline)
    _zip(offline, PLANS[:2], bad=False)
    for m in (cubicasa, jc):
        assert m.N_TEST == 500
        with pytest.raises(ValueError):
            m.sample(1, fallback=None)
    for g, jg in zip(cubicasa.sample(3, 'test'), jc.sample(3, 'test')):
        _same_geometry(g, jg)


_NO_JAX_CACHE = """
import os, sys
from pathlib import Path
from megastep_tpu_torch import cubicasa, floorplans
assert cubicasa.ROOT == Path(os.environ['MEGASTEP_TPU_CACHE']) / 'cubicasa'
def no_download(*args, **kwargs):
    raise RuntimeError('offline')
cubicasa.download = no_download
assert not cubicasa.cache_path().exists()
got = cubicasa.sample(3)
want = floorplans.sample(3, seed=1)
assert all((g.walls == w.walls).all() for g, w in zip(got, want))
print(sorted(m for m in sys.modules if m.split('.')[0] in
             ('jax', 'flax', 'megastep_tpu', 'bs4', 'lxml')))
"""


def test_never_opens_the_jax_cache(jc, tmp_path, monkeypatch):
    """A JAX cache alone in ``ROOT``: the port falls back to procedural plans
    and imports nothing of JAX, which unpickling that cache would do."""
    root = tmp_path / 'cubicasa'                # ROOT under MEGASTEP_TPU_CACHE
    root.mkdir()
    _offline(jc, monkeypatch, root)
    _zip(root, PLANS[:1])
    jc.geometry_data(backend='serial')
    (root / 'cubicasa5k.zip').unlink()
    assert list(root.iterdir()) == [root / f'geometries-v{jc.CACHE_VERSION}.pkl.gz']
    env = {**os.environ, 'PYTHONPATH': str(REPO), 'MEGASTEP_TPU_CACHE': str(tmp_path),
           'MEGASTEP_TPU_CUBICASA_AGREE': '0'}
    out = subprocess.run([sys.executable, '-c', _NO_JAX_CACHE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         stdin=subprocess.DEVNULL)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'


@pytest.mark.parametrize('split,seed', [('training', 1), ('test', 2)])
def test_offline_fallback_is_procedural(split, seed):
    got, want = cubicasa.sample(3, split), floorplans.sample(3, seed=seed)
    for g, w in zip(got, want):
        for k in ('walls', 'lights', 'masks'):
            np.testing.assert_array_equal(g[k], w[k])
    with pytest.raises(RuntimeError, match='offline'):
        cubicasa.sample(3, split, fallback=None)


def test_envs_default_to_cubicasa_sample():
    """Offline, ``geometries=None`` builds exactly the env the port built from
    ``floorplans.sample(n, seed=1)`` before it had the dataset pipeline."""
    for cls, n, n_scenes, kw in ((Explorer, 3, 3, dict(res=32)),
                                 (Deathmatch, 8, 2, dict(res=32))):
        env = cls(n, random=np.random.RandomState(0), device='cpu', **kw)
        ref = cls(n, geometries=floorplans.sample(n_scenes, seed=1),
                  random=np.random.RandomState(0), device='cpu', **kw)
        np.testing.assert_array_equal(env.scene_order, ref.scene_order)
        for k in ('lines', 'lines_width', 'textures', 'baked', 'lights'):
            assert torch.equal(getattr(env.core.scenery, k),
                               getattr(ref.core.scenery, k)), (cls.__name__, k)


def test_real_markup_drives_engine(jc):
    """A parsed plan feeds the engine end to end (the port's counterpart of
    ``tests/test_cubicasa_svg.py::test_real_markup_drives_engine``): scenery,
    Core, one physics step and one render, against the JAX package's."""
    jcore = pytest.importorskip('megastep_tpu.core')
    import jax.numpy as jnp
    from megastep_tpu import scene as jscene
    svg = _fixture('apartment_a')
    g, jg = cubicasa.svg_geometry('apartment_a', svg), jc.svg_geometry('apartment_a', svg)
    c = core.Core(scene.scenery([g], 1, random=np.random.RandomState(0), device='cpu'),
                  res=32, fov=130, fps=10)
    jcr = jcore.Core(jscene.scenery([jg], 1, random=np.random.RandomState(0)),
                     res=32, fov=130, fps=10)
    agents, jagents = c.init_agents(), jcr.init_agents()
    agents['positions'] = torch.tensor(g.lights[:1][None], dtype=torch.float32)
    jagents['positions'] = jnp.asarray(jg.lights[:1][None])
    agents, progress = c.physics(agents)
    jagents, _ = jcr.physics(jagents)
    r, jr = c.render(agents), jcr.render(jagents)
    assert (r.indices >= 0).all()              # closed apartment: every ray hits
    assert float(r.distances.min()) > 0
    np.testing.assert_array_equal(r.indices.numpy(), np.asarray(jr.indices))
    for k in ('distances', 'screen'):
        np.testing.assert_allclose(r[k].numpy(), np.asarray(jr[k]), **TOL, err_msg=k)
