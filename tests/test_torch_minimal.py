"""The port's Minimal env and the modules it is built of (``SimpleMovement``,
``Core.render``, the conv-layout ``modules.render``, ``RGB``, ``Depth``, and
``RandomLifespans``) against the JAX package's, on the CPU.

Both packages get the same host-built scenery (the same numpy seeds) and the
same draws: the JAX modules draw from PRNG keys, and the test hands the port
the same integers (``jax.random.randint`` of those keys). Indices, resets and
lifespans must be equal; floats pass allclose(rtol=1e-5, atol=1e-6). The
SimpleMovement trajectories are the frozen numbers of ``tests/test_golden.py``,
at that file's tolerances.
"""
import importlib

import numpy as np
import pytest
import torch

from megastep_tpu_torch import core, modules, scene, toys
from megastep_tpu_torch.arrdict import arrdict
from megastep_tpu_torch.envs import Minimal

train = importlib.import_module('megastep_tpu_torch.demo.train')

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
N, RES = 4, 64


@pytest.fixture(scope='module')
def jx():
    pytest.importorskip('megastep_tpu.envs')
    import jax
    import jax.numpy as jnp
    from megastep_tpu import core as jcore, modules as jmodules, scene as jscene
    from megastep_tpu import toys as jtoys
    from megastep_tpu.arrdict import arrdict as jarrdict
    from megastep_tpu.envs import Minimal as JMinimal
    return arrdict(jax=jax, jnp=jnp, core=jcore, modules=jmodules, scene=jscene,
                   toys=jtoys, arrdict=jarrdict, Minimal=JMinimal)


# --- SimpleMovement: tests/test_golden.py's frozen trajectories ----------------

@pytest.fixture(scope='module')
def sim():
    scn = scene.scenery([toys.box()], n_agents=1, random=np.random.RandomState(7),
                        device='cpu')
    c = core.Core(scn, res=64, fov=130, fps=10)
    return c, modules.SimpleMovement(c)


def _rollout(c, mover, actions):
    agents = c.init_agents()
    agents['positions'] = torch.full_like(agents.positions, 3.5)
    pos, progress = [], []
    for a in actions:
        agents, p = mover(agents, arrdict(actions=torch.full((1, 1), a)))
        pos.append(agents.positions[0, 0].numpy())
        progress.append(float(p[0, 0]))
    return np.stack(pos), np.array(progress), agents


def test_golden_free_flight(sim):
    pos, progress, _ = _rollout(*sim, [1] * 3)
    np.testing.assert_allclose(progress, 1., atol=1e-6)
    np.testing.assert_allclose(pos[:, 1] - 3.5, [.1, .2, .3], atol=1e-5)
    np.testing.assert_allclose(pos[:, 0], 3.5, atol=1e-6)


def test_golden_wall_stop(sim):
    pos, progress, _ = _rollout(*sim, [3] * 40)
    assert progress[-1] == 0.
    np.testing.assert_allclose(pos[-1, 0], 5.89383, atol=1e-4)
    np.testing.assert_allclose(pos[-1, 1], 3.5, atol=1e-6)
    np.testing.assert_allclose(pos[-1], pos[-5], atol=1e-6)


def test_golden_turn(sim):
    _, _, agents = _rollout(*sim, [5] * 5)
    np.testing.assert_allclose(float(agents.angles[0, 0]), 5 * 1.8, atol=1e-4)
    np.testing.assert_allclose(agents.positions[0, 0].numpy(), 3.5, atol=1e-6)


# --- Render and observers ------------------------------------------------------

def _boxes(jx):
    """The same four boxes in both packages, and random poses inside them."""
    ours = core.Core(scene.scenery(N * [toys.box()], 1, random=np.random.RandomState(2),
                                   device='cpu'), res=RES)
    theirs = jx.core.Core(jx.scene.scenery(N * [jx.toys.box()], 1,
                                           random=np.random.RandomState(2)), res=RES)
    rng = np.random.RandomState(3)
    poses = dict(angles=rng.uniform(-180, 180, (N, 1)).astype(np.float32),
                 positions=rng.uniform(1.5, 5.5, (N, 1, 2)).astype(np.float32),
                 angvelocity=np.zeros((N, 1), np.float32),
                 velocity=np.zeros((N, 1, 2), np.float32))
    agents = arrdict({k: torch.from_numpy(v) for k, v in poses.items()})
    jagents = jx.arrdict({k: jx.jnp.asarray(v) for k, v in poses.items()})
    return ours, theirs, agents, jagents


def _same(ours, theirs):
    for k in ours:
        if k == 'indices':
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]))
        else:
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]),
                                       **TOL, err_msg=k)


def test_render_and_observers_match_jax(jx):
    ours, theirs, agents, jagents = _boxes(jx)
    r, jr = ours.render(agents), theirs.render(jagents)
    assert r.screen.shape == (N, 1, RES, 3)
    assert (r.indices >= 0).all()                  # closed boxes: every ray hits
    _same(r, jr)

    r, jr = modules.render(ours, agents), jx.modules.render(theirs, jagents)
    assert r.screen.shape == (N, 1, 3, 1, RES) and r.distances.shape == (N, 1, 1, RES)
    _same(r, jr)
    # The conv layout holds the render's pixels: a permute, not a reshape.
    np.testing.assert_array_equal(r.screen[:, :, :, 0].numpy(),
                                  ours.render(agents).screen.permute(0, 1, 3, 2).numpy())

    for s in (1, 4):
        rgb, jrgb = modules.RGB(ours, subsample=s), jx.modules.RGB(theirs, subsample=s)
        depth = modules.Depth(ours, subsample=s)
        jdepth = jx.modules.Depth(theirs, subsample=s)
        assert rgb(r).shape == (N, 1, 3, 1, RES // s)
        assert tuple(rgb.space.shape) == tuple(jrgb.space.shape) == (1, 3, 1, RES // s)
        assert depth(r).shape == (N, 1, 1, 1, RES // s)
        _same(arrdict(rgb=rgb(r), d=depth(r), rgb_fresh=rgb(agents=agents),
                      d_fresh=depth(agents=agents)),
              dict(rgb=jrgb(jr), d=jdepth(jr), rgb_fresh=jrgb(agents=jagents),
                   d_fresh=jdepth(agents=jagents)))


# --- RandomLifespans -----------------------------------------------------------

def test_lifespans_match_jax_on_given_draws(jx):
    jax = jx.jax
    c = core.Core(scene.scenery(N * [toys.box()], 2, random=np.random.RandomState(0),
                                bake_fn=None, device='cpu'))
    jc = jx.core.Core(jx.scene.scenery(N * [jx.toys.box()], 2,
                                       random=np.random.RandomState(0), bake_fn=None))
    ours, theirs = modules.RandomLifespans(c, 6), jx.modules.RandomLifespans(jc, 6)

    def draws(key):
        return torch.tensor(np.asarray(
            jax.random.randint(key, (N, 2), theirs.min_lifespan, theirs.max_lifespan)))

    key = jax.random.PRNGKey(1)
    state, jstate = ours.init_state(draws(key)), theirs.init_state(key)
    resets = 0
    for t in range(12):
        key = jax.random.fold_in(key, t)
        forced = np.zeros((N, 2), bool)
        forced[t % N, t % 2] = t % 3 == 0
        state, reset = ours(state, draws(key), torch.from_numpy(forced))
        jstate, jreset = theirs(jstate, key, jx.jnp.asarray(forced))
        np.testing.assert_array_equal(reset.numpy(), np.asarray(jreset))
        for k in ('lifespans', 'max_lifespans'):
            np.testing.assert_array_equal(state[k].numpy(), np.asarray(jstate[k]))
        resets += int(reset.sum())
    assert resets > N * 2                          # lifespans ran out, not only forced

    g = torch.Generator().manual_seed(0)
    drawn = torch.stack([ours.init_state(g).max_lifespans for _ in range(64)])
    assert drawn.dtype == torch.int32
    assert int(drawn.min()) == 3 and int(drawn.max()) == 5   # [6 // 2, 6)


# --- Minimal -------------------------------------------------------------------

def test_minimal_matches_jax(jx):
    jax = jx.jax
    np.random.seed(11)
    env = Minimal(N, device='cpu')
    np.random.seed(11)
    jenv = jx.Minimal(N)
    assert env.obs_space.shape == jenv.obs_space.shape == (1, 3, 1, RES)
    assert env.action_space.shape == jenv.action_space.shape

    key = jax.random.PRNGKey(5)
    choices = torch.tensor(np.asarray(jax.random.randint(key, (N, 1), 0, 100)))
    state, world = env.reset(choices)
    jstate, jworld = jenv.reset(key)
    actions = np.random.RandomState(6).randint(0, 7, (3, N, 1))
    for t in range(4):
        np.testing.assert_allclose(world.obs.numpy(), np.asarray(jworld.obs), **TOL)
        for k in ('angles', 'positions'):
            np.testing.assert_allclose(state.agents[k].numpy(),
                                       np.asarray(jstate.agents[k]), **TOL, err_msg=k)
        np.testing.assert_allclose(state.progress.numpy(), np.asarray(jstate.progress),
                                   **TOL)
        if t < 3:
            state, world = env.step(state, arrdict(actions=torch.from_numpy(actions[t])))
            jstate, jworld = jenv.step(
                jstate, jx.arrdict(actions=jx.jnp.asarray(actions[t])), key)
    assert ((world.obs >= 0) & (world.obs <= 1)).all()


class _MinimalWorld(Minimal):
    """Minimal with the reward/reset keys the train loop reads, as
    ``tests/test_demo_integration.py`` wraps the JAX env."""

    def reset(self, rng):
        state, world = super().reset(rng)
        world['reward'] = self.core.env_full(0.)
        world['reset'] = self.core.env_full(True)
        return state, world

    def step(self, state, decision, rng=None):
        state, world = super().step(state, decision, rng)
        world['reward'] = self.core.env_full(0.)
        world['reset'] = self.core.env_full(False)
        return state, world


def test_train_on_minimal(tmp_path, monkeypatch):
    from megastep_tpu_torch.rebar import paths
    monkeypatch.setattr(paths, 'ROOT', str(tmp_path))  # train() writes a run directory
    np.random.seed(0)
    env = _MinimalWorld(4, device='cpu')
    carry, history = train.train(env=env, width=8, buffer_size=4, batch_size=16,
                                 steps=2, device='cpu', run_name='minimal')
    assert len(history) == 2 and all(train.is_finite(m) for m in history)
    assert carry.world.obs.shape == (4, 1, 3, 1, RES)
