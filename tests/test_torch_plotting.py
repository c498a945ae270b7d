"""The port's state snapshots, plotting functions and figures against the JAX
package's, on the CPU.

Each env pair is built from the same geometries and RandomState, reset with the
JAX env's spawn draws (``jax.random.randint`` of its key, as
``tests/test_torch_{minimal,explorer,deathmatch}.py`` do) and stepped twice with
the same actions; the JAX envs run their plain path (``fused=False``).
Snapshots: keys, Python scalars, dtypes, shapes, indices, masks and widths must
be equal; floats allclose(rtol=1e-5, atol=1e-6). Plotting functions on one
snapshot: equal. Figures: each package's ``plot_state`` (and
``scene.display``) draws the same numpy snapshot, and each package's
``recording.array`` renders it; the uint8 pixels must be equal.
"""
import matplotlib
matplotlib.use('Agg')

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import matplotlib.pyplot as plt

from megastep_tpu import (core as jcore, floorplans as jfloorplans, modules as jmodules,
                          plotting as jplotting, scene as jscene, toys as jtoys)
from megastep_tpu.arrdict import arrdict as jarrdict
from megastep_tpu.envs import (Deathmatch as JDeathmatch, Explorer as JExplorer,
                               Minimal as JMinimal)
from megastep_tpu.rebar import recording as jrecording
from megastep_tpu_torch import core, floorplans, modules, plotting, scene, toys
from megastep_tpu_torch.arrdict import arrdict
from megastep_tpu_torch.envs import Deathmatch, Explorer, Minimal
from megastep_tpu_torch.rebar import recording

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
RES, N_SPAWNS, STEPS = 64, 100, 2
DPI = 50  # small figures keep the renders cheap


def _spawns(key, shape):
    return torch.tensor(np.asarray(jax.random.randint(key, shape, 0, N_SPAWNS)))


def _run(env, jenv, shape, seed):
    """Reset both envs with the JAX draws and step both ``STEPS`` times with the
    same actions. Returns ``(env, state, world), (jenv, jstate, jworld)``."""
    key = jax.random.PRNGKey(seed)
    state, world = env.reset(_spawns(key, shape))
    jstate, jworld = jax.jit(jenv.reset)(key)
    jstep = jax.jit(jenv.step)
    actions = np.random.RandomState(seed).randint(0, 7, (STEPS, env.n_envs, 1))
    for t in range(STEPS):
        key = jax.random.fold_in(key, t)
        state, world = env.step(state, arrdict(actions=torch.from_numpy(actions[t])),
                                _spawns(key, shape))
        jstate, jworld = jstep(jstate, jarrdict(actions=jnp.asarray(actions[t])), key)
    return (env, state, world), (jenv, jstate, jworld)


@pytest.fixture(scope='module')
def minimal():
    np.random.seed(11)
    env = Minimal(2, device='cpu')
    np.random.seed(11)
    jenv = JMinimal(2)
    return _run(env, jenv, (2, 1), 5)


@pytest.fixture(scope='module')
def explorer():
    geoms = floorplans.sample(2, seed=7) + [toys.column()]
    jgeoms = jfloorplans.sample(2, seed=7) + [jtoys.column()]
    env = Explorer(3, geometries=geoms, res=RES, subsample=4,
                   random=np.random.RandomState(12), device='cpu')
    jenv = JExplorer(3, geometries=jgeoms, res=RES, subsample=4, fused=False,
                     random=np.random.RandomState(12))
    return _run(env, jenv, (3, 1), 3)


@pytest.fixture(scope='module')
def deathmatch():
    env = Deathmatch(8, geometries=floorplans.sample(2, seed=3), res=RES,
                     random=np.random.RandomState(5), device='cpu')
    jenv = JDeathmatch(8, geometries=jfloorplans.sample(2, seed=3), res=RES,
                       fused=False, random=np.random.RandomState(5))
    return _run(env, jenv, (2, 4), 4)


ENVS = ('minimal', 'explorer', 'deathmatch')


def assert_same_tree(got, want, path='state'):
    """Equal keys, Python scalars of equal type and value, numpy leaves of equal
    dtype and shape: exact for indices, masks and widths, allclose for floats."""
    if isinstance(want, dict):
        assert type(got).__name__ == type(want).__name__, path
        assert list(got) == list(want), (path, list(got), list(want))
        for k in want:
            assert_same_tree(got[k], want[k], f'{path}.{k}')
        return
    if not isinstance(want, np.ndarray | np.generic):
        assert type(got) is type(want) and got == want, (path, got, want)
        return
    assert isinstance(got, np.ndarray | np.generic), (path, type(got))
    assert got.dtype == want.dtype and got.shape == want.shape, (
        path, got.dtype, want.dtype, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, **TOL, err_msg=path)
    else:
        np.testing.assert_array_equal(got, want, err_msg=path)


def _numpy_tree(tree, make):
    """A numpy snapshot rebuilt with the dict types ``make`` names by class
    name (the port's ``dotdict`` and ``arrdict``)."""
    if isinstance(tree, dict):
        return make[type(tree).__name__]({k: _numpy_tree(v, make) for k, v in tree.items()})
    return tree


def _pixels(array, fig):
    out = array(fig)
    plt.close(fig)
    return out


@pytest.mark.parametrize('name', ENVS)
def test_env_state_matches_jax(request, name):
    (env, state, world), (jenv, jstate, jworld) = request.getfixturevalue(name)
    for e in (0, env.core.n_envs - 1):
        assert_same_tree(env.state(state, world, e), jenv.state(jstate, jworld, e))


@pytest.mark.parametrize('name', ENVS)
def test_scenery_and_core_state_match_jax(request, name):
    (env, state, _), (jenv, jstate, _) = request.getfixturevalue(name)
    for e in (0, env.core.n_envs - 1):
        assert_same_tree(env.core.scenery.state(e), jenv.core.scenery.state(e))
        assert_same_tree(env.core.state(state.agents, state.progress, e),
                         jenv.core.state(jstate.agents, jstate.progress, e))


def test_explorer_seen_spans_the_texels(explorer):
    (env, state, world), _ = explorer
    for e in range(env.n_envs):
        snap = env.state(state, world, e)
        assert snap.seen.shape == (int(env.core.scenery.tex_width[e]),)
        assert snap.seen.shape == snap.core.scenery.textures.vals.shape[:1]
        assert snap.max_length == snap.potential + 200
    assert any(env.state(state, world, e).seen.any() for e in range(env.n_envs))


def test_random_lifespans_state_matches_jax(explorer):
    (env, _, _), (jenv, _, _) = explorer
    draws = np.random.RandomState(2).randint(4, 8, (env.n_envs, 1))
    lives = modules.RandomLifespans(env.core, 8)
    jlives = jmodules.RandomLifespans(jenv.core, 8)
    state = lives.init_state(torch.from_numpy(draws))
    jstate = jarrdict(lifespans=jnp.zeros((env.n_envs, 1), jnp.int32),
                      max_lifespans=jnp.asarray(draws, jnp.int32))
    for e in range(env.n_envs):
        assert_same_tree(lives.state(state, e), jlives.state(jstate, e))


def test_plotting_functions_match_jax(explorer):
    (env, state, world), _ = explorer
    snap = env.state(state, world, 0).core
    for got, want in zip(plotting.texel_frames(snap.scenery),
                         jplotting.texel_frames(snap.scenery)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(plotting.line_arrays(snap), jplotting.line_arrays(snap)):
        np.testing.assert_array_equal(got, want)
    assert plotting.n_agent_texels(snap.scenery) == jplotting.n_agent_texels(snap.scenery)
    for zoom in (True, False):
        assert plotting.extent(snap, zoom) == jplotting.extent(snap, zoom)
    obs = env.state(state, world, 0)
    arrs = {'rgb': obs.rgb, 'd': obs.d}
    got, want = plotting.imshow_arrays(arrs), jplotting.imshow_arrays(arrs)
    assert list(got) == list(want)
    for a in want:
        np.testing.assert_array_equal(got[a], want[a])
    moved = {k: np.moveaxis(v, 1, 3) for k, v in arrs.items()}
    got = plotting.imshow_arrays(moved, transpose=True)
    for a, im in jplotting.imshow_arrays(moved, transpose=True).items():
        np.testing.assert_array_equal(got[a], im)


def _figures(name, fixture):
    """(port figure, JAX figure) pairs for ``name``'s plot_state on the JAX
    snapshot of env 0, in each package's dict types."""
    (env, _, _), (jenv, jstate, jworld) = fixture
    snap = jenv.state(jstate, jworld, 0)
    if name == 'deathmatch':
        snap['decision'] = jarrdict(value=np.array([.25], np.float32))
    from megastep_tpu_torch.dotdict import dotdict
    mine = _numpy_tree(snap, {'arrdict': arrdict, 'dotdict': dotdict})
    return type(env).plot_state(mine), type(jenv).plot_state(snap)


@pytest.mark.parametrize('name', ENVS)
def test_plot_state_pixels_equal_jax(request, name):
    fixture = request.getfixturevalue(name)
    with matplotlib.rc_context({'figure.dpi': DPI}):
        fig, jfig = _figures(name, fixture)
        got, want = _pixels(recording.array, fig), _pixels(jrecording.array, jfig)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.shape[0] % 2 == 0 and got.shape[1] % 2 == 0
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 8, 'a blank figure'


def test_display_core_and_rgb_pixels_equal_jax(explorer):
    (env, _, _), (jenv, jstate, jworld) = explorer
    plt.close('all')  # display() draws into the current figure, if there is one
    with matplotlib.rc_context({'figure.dpi': DPI}):
        got = _pixels(recording.array, scene.display(env.core.scenery, e=1))
        want = _pixels(jrecording.array, jscene.display(jenv.core.scenery, e=1))
        np.testing.assert_array_equal(got, want)

        snap = jenv.state(jstate, jworld, 2)
        for zoom in (False, True):
            fig, jfig = plt.figure(), plt.figure()
            core.Core.plot_state(snap.core, fig.gca(), zoom=zoom)
            jcore.Core.plot_state(snap.core, jfig.gca(), zoom=zoom)
            np.testing.assert_array_equal(_pixels(recording.array, fig),
                                          _pixels(jrecording.array, jfig))

        fig, jfig = plt.figure(), plt.figure()
        modules.RGB.plot_state(snap.rgb, [fig.gca()])
        jmodules.RGB.plot_state(snap.rgb, [jfig.gca()])
        np.testing.assert_array_equal(_pixels(recording.array, fig),
                                      _pixels(jrecording.array, jfig))
