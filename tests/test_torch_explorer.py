"""A short trajectory of the port's Explorer against the JAX package's, on the CPU.

Both envs are built from the same geometries and the same RandomState, and are
given the same actions and the same spawn-slot choices: the JAX env draws its
choices from a PRNG key, and the test reproduces them with
``jax.random.randint(key, (N, 1), 0, n_spawns)`` for the port. One geometry is an
unwalled room, so rays miss (misses mark no texel seen), and one env is forced
to reset. Observations, reward and potential are held to
allclose(rtol=1e-5, atol=1e-6); reset flags and the seen mask must match exactly.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from megastep_tpu import floorplans as jfloorplans, toys as jtoys
from megastep_tpu.arrdict import arrdict as jarrdict
from megastep_tpu.envs import Explorer as JExplorer
from megastep_tpu_torch import floorplans, interop, toys
from megastep_tpu_torch.arrdict import arrdict
from megastep_tpu_torch.envs import Explorer

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
N, RES, STEPS, N_SPAWNS = 4, 64, 4, 100


def _choices(key):
    return torch.tensor(np.asarray(jax.random.randint(key, (N, 1), 0, N_SPAWNS)))


def _compare(state, world, jstate, jworld):
    for k in ('rgb', 'd', 'imu'):
        np.testing.assert_allclose(world.obs[k].numpy(), np.asarray(jworld.obs[k]),
                                   **TOL, err_msg=k)
    np.testing.assert_allclose(world.reward.numpy(), np.asarray(jworld.reward), **TOL)
    np.testing.assert_array_equal(world.reset.numpy(), np.asarray(jworld.reset))
    np.testing.assert_array_equal(state.seen.numpy(), np.asarray(jstate.seen))
    np.testing.assert_allclose(state.potential.numpy(), np.asarray(jstate.potential),
                               **TOL)


def test_explorer_trajectory_matches_jax():
    geoms = floorplans.sample(3, seed=7) + [toys.column()]
    jgeoms = jfloorplans.sample(3, seed=7) + [jtoys.column()]
    env = Explorer(N, geometries=geoms, res=RES, subsample=4,
                   random=np.random.RandomState(12), device='cpu')
    jenv = JExplorer(N, geometries=jgeoms, res=RES, subsample=4, fused=False,
                     random=np.random.RandomState(12))
    np.testing.assert_array_equal(env.scene_order, jenv.scene_order)
    assert env.obs_space.rgb.shape == jenv.obs_space.rgb.shape == (1, 3, 1, RES // 4)
    assert env.obs_space.d.shape == jenv.obs_space.d.shape == (1, 1, 1, RES // 4)

    key = jax.random.PRNGKey(3)
    state, world = env.reset(_choices(key))
    jstate, jworld = jenv.reset(key)
    _compare(state, world, jstate, jworld)

    jstep = jax.jit(jenv.step)
    actions = np.random.RandomState(4).randint(0, 7, (STEPS, N, 1))
    missed = False
    for t in range(STEPS):
        if t == 2:
            # Force env 0 to reset on this step: lengths >= potential + 200.
            lengths = np.array(jstate.lengths)
            lengths[0] = int(np.asarray(jstate.potential)[0]) + 199
            jstate['lengths'] = jnp.asarray(lengths)
            state['lengths'] = torch.from_numpy(lengths.copy())
        key = jax.random.fold_in(key, t)
        state, world = env.step(
            state, arrdict(actions=torch.from_numpy(actions[t])), _choices(key))
        jstate, jworld = jstep(jstate, jarrdict(actions=jnp.asarray(actions[t])), key)
        _compare(state, world, jstate, jworld)
        missed |= bool((world.obs.d == 0).any())
        if t == 2:
            assert bool(world.reset[0]) and not bool(world.reset[1:].any())
            assert float(world.reward[0]) == 0.
    assert missed, 'the trajectory should include rays that hit nothing'

    # The JAX state, carried across through numpy, is the port's state.
    carried = interop.state_from_numpy(
        {k: ({kk: np.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
             else np.asarray(v)) for k, v in jstate.items()}, device='cpu')
    for k in ('progress', 'potential'):
        np.testing.assert_allclose(carried[k].numpy(), state[k].numpy(), **TOL)
    for k in ('seen', 'lengths'):
        np.testing.assert_array_equal(carried[k].numpy(), state[k].numpy())
    for k in state.agents:
        np.testing.assert_allclose(carried.agents[k].numpy(),
                                   state.agents[k].numpy(), **TOL)


def test_explorer_generator_draws_and_default_geometries(tmp_path, monkeypatch):
    """With a torch.Generator in place of given choices, and geometries=None
    (``cubicasa.sample(n_envs)``, offline here: ``floorplans.sample(n_envs,
    seed=1)``), the env runs and stays consistent."""
    from megastep_tpu_torch import cubicasa

    def no_download(*args, **kwargs):
        raise RuntimeError('offline test: no download')
    monkeypatch.setattr(cubicasa, 'ROOT', tmp_path)
    monkeypatch.setattr(cubicasa, 'download', no_download)
    env = Explorer(2, res=32, random=np.random.RandomState(0), device='cpu')
    g = torch.Generator().manual_seed(0)
    state, world = env.reset(g)
    assert world.obs.rgb.shape == (2, 1, 3, 1, 8)
    assert world.obs.d.shape == (2, 1, 1, 1, 8)
    assert world.obs.imu.shape == (2, 1, 3)
    for _ in range(3):
        prev = state.potential
        state, world = env.step(
            state, arrdict(actions=torch.randint(0, 7, (2, 1), generator=g)), g)
        assert (state.potential >= prev).all()
        assert (world.reward >= 0).all()
        assert ((world.obs.rgb >= 0) & (world.obs.rgb <= 1)).all()
    np.testing.assert_array_equal(state.potential.numpy(),
                                  state.seen.sum(-1).float().numpy())
    with pytest.raises(ValueError):
        env.reset(torch.zeros((3, 1), dtype=torch.int64))
