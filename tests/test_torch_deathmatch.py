"""The port's Deathmatch against the JAX package's, on the CPU.

Both envs are built from the same geometries and the same RandomState, and are
given the same actions and the same spawn-slot choices: the JAX env draws its
choices from a PRNG key, and the test reproduces them with
``jax.random.randint(key, (n_scenes, 4), 0, n_spawns)`` for the port. The JAX env
runs its plain path (``fused=False``: draw, raycast, re-bake, shade); the port
runs its one observe call, whose CPU version is the kernel's plain version.
States are carried across through ``interop`` for the scripted cases: a shot that
lands, and an agent that respawns. Matchings and reset flags must be equal;
health, damage and reward are held to allclose(atol=1e-6), observations to
allclose(rtol=1e-5, atol=1e-6).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from megastep_tpu import floorplans as jfloorplans, toys as jtoys
from megastep_tpu.arrdict import arrdict as jarrdict
from megastep_tpu.envs import Deathmatch as JDeathmatch
from megastep_tpu_torch import floorplans, interop, toys
from megastep_tpu_torch.arrdict import arrdict
from megastep_tpu_torch.envs import Deathmatch

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
A, N_SCENES, RES, N_SPAWNS = 4, 2, 64, 100
N = N_SCENES * A


def _choices(key):
    return torch.tensor(np.asarray(jax.random.randint(key, (N_SCENES, A), 0, N_SPAWNS)))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return np.array(tree)


def _carry(state):
    """One numpy state as the JAX env's state and as the port's."""
    jstate = jax.tree_util.tree_map(jnp.asarray, jarrdict(
        {k: (jarrdict(v) if isinstance(v, dict) else v) for k, v in state.items()}))
    return jstate, interop.state_from_numpy(state, device='cpu')


def _compare(state, world, jstate, jworld):
    for k in ('rgb', 'd', 'imu', 'health'):
        np.testing.assert_allclose(world.obs[k].numpy(), np.asarray(jworld.obs[k]),
                                   **TOL, err_msg=k)
    np.testing.assert_allclose(world.reward.numpy(), np.asarray(jworld.reward),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(world.reset.numpy(), np.asarray(jworld.reset))
    np.testing.assert_array_equal(state.matchings.numpy(), np.asarray(jstate.matchings))
    for k in ('health', 'damage'):
        np.testing.assert_allclose(state[k].numpy(), np.asarray(jstate[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    for k in ('positions', 'angles'):
        np.testing.assert_allclose(state.agents[k].numpy(),
                                   np.asarray(jstate.agents[k]), **TOL, err_msg=k)


@pytest.fixture(scope='module')
def floorplan_jax():
    """The JAX env on two floorplans, and its jitted step."""
    jenv = JDeathmatch(N, geometries=jfloorplans.sample(N_SCENES, seed=3), res=RES,
                       fused=False, random=np.random.RandomState(5))
    return jenv, jax.jit(jenv.step)


@pytest.fixture(scope='module')
def box_envs():
    """Both envs on two empty square rooms, where scripted poses are free."""
    env = Deathmatch(N, geometries=[toys.box(), toys.box()], res=RES,
                     random=np.random.RandomState(5), device='cpu')
    jenv = JDeathmatch(N, geometries=[jtoys.box(), jtoys.box()], res=RES,
                       fused=False, random=np.random.RandomState(5))
    return env, jenv, jax.jit(jenv.step)


@pytest.mark.parametrize('draw_fused', [False, True])
def test_deathmatch_trajectory_matches_jax(floorplan_jax, draw_fused):
    jenv, jstep = floorplan_jax
    env = Deathmatch(N, geometries=floorplans.sample(N_SCENES, seed=3), res=RES,
                     random=np.random.RandomState(5), draw_fused=draw_fused,
                     device='cpu')
    np.testing.assert_array_equal(env.scene_order, jenv.scene_order)
    assert env.n_envs == jenv.n_envs == N
    for k in ('rgb', 'd', 'imu', 'health'):
        assert env.obs_space[k].shape == jenv.obs_space[k].shape, k

    key = jax.random.PRNGKey(0)
    state, world = env.reset(_choices(key))
    jstate, jworld = jenv.reset(key)
    _compare(state, world, jstate, jworld)
    assert world.obs.rgb.shape == (N, 1, 3, 1, RES // 4)
    assert world.obs.health.shape == (N, 1, 1)

    actions = np.random.RandomState(1).randint(0, 7, (3, N, 1))
    for t in range(3):
        key = jax.random.fold_in(key, t)
        state, world = env.step(
            state, arrdict(actions=torch.from_numpy(actions[t])), _choices(key))
        jstate, jworld = jstep(jstate, jarrdict(actions=jnp.asarray(actions[t])), key)
        _compare(state, world, jstate, jworld)


def test_deathmatch_shot_lands(box_envs):
    """Agent 0 faces agent 1 a meter away in an empty room: both packages match
    shooter 0 to target 1, charge the hit and the wound, and agree on the rest."""
    env, jenv, jstep = box_envs
    key = jax.random.PRNGKey(1)
    jstate, _ = jenv.reset(key)
    state = _numpy(jstate)
    poses = {0: (2.5, 3.5, 0.), 1: (3.5, 3.5, 180.), 2: (2., 5.5, 90.),
             3: (5., 1.5, -90.)}
    for a, (x, y, angle) in poses.items():
        state['agents']['positions'][:, a] = (x, y)
        state['agents']['angles'][:, a] = angle
    state['agents']['velocity'][:] = 0.
    state['agents']['angvelocity'][:] = 0.
    jstate, ours = _carry(state)

    actions = np.zeros((N, 1), np.int32)
    key = jax.random.fold_in(key, 1)
    ours, world = env.step(ours, arrdict(actions=torch.from_numpy(actions)),
                           _choices(key))
    jstate, jworld = jstep(jstate, jarrdict(actions=jnp.asarray(actions)), key)
    _compare(ours, world, jstate, jworld)
    assert ours.matchings[:, 0, 1].all() and ours.matchings[:, 1, 0].all()
    assert np.asarray(jstate.matchings)[:, 0, 1].all()
    # Shooters 0 and 1 each land one hit, their reward; the others none.
    np.testing.assert_array_equal(world.reward.reshape(N_SCENES, A).numpy(),
                                  [[1., 1., 0., 0.]] * N_SCENES)


def test_deathmatch_respawns_the_dead(box_envs):
    """One agent's health at or below 0 respawns it (new pose from the spawn
    table, health back to 1, damage to 0) in both packages, and only it."""
    env, jenv, jstep = box_envs
    key = jax.random.PRNGKey(2)
    jstate, _ = jenv.reset(key)
    state = _numpy(jstate)
    state['health'][1, 2] = 0.
    state['damage'][1, 2] = .3
    jstate, ours = _carry(state)
    before = ours.agents.positions.clone()

    actions = np.zeros((N, 1), np.int32)
    key = jax.random.fold_in(key, 2)
    choices = _choices(key)
    ours, world = env.step(ours, arrdict(actions=torch.from_numpy(actions)), choices)
    jstate, jworld = jstep(jstate, jarrdict(actions=jnp.asarray(actions)), key)
    _compare(ours, world, jstate, jworld)

    reset = world.reset.reshape(N_SCENES, A)
    assert reset[1, 2] and reset.sum() == 1
    spawn = env._spawner._spawns.positions[1, 2, choices[1, 2]]
    np.testing.assert_array_equal(ours.agents.positions[1, 2].numpy(), spawn.numpy())
    assert not torch.equal(ours.agents.positions[1, 2], before[1, 2])
    assert ours.health[1, 2] > .9 and ours.damage[1, 2] == 0.
