"""The port's multi-device layer (``megastep_tpu_torch.parallel`` and the
``mesh=`` path of ``demo.train``) against the JAX package's, on the CPU.

Two gloo ranks run in one spawn of two processes (the ``ranks`` fixture), with
a file rendezvous in the fixture's temporary directory. The spawn runs every
two-rank check and writes each rank's results to a file; the tests assert on
them. While the ranks run, the fixture computes the JAX references in this
process. The join has a time limit.

Tolerances:
- a rank's build against the JAX env built locally as
  ``megastep_tpu/parallel/host.py:99-107`` and ``:126-131`` build it: every
  scenery field and ``scene_order`` exactly, except ``baked``,
  allclose(rtol=1e-5, atol=1e-6) as ``tests/test_torch_scene.py`` holds the
  bake; after a reset and 3 steps with the same spawn draws and actions,
  observations and rewards allclose(rtol=1e-5, atol=1e-6), resets and the
  seen mask exactly;
- the two-rank learner against JAX ``optimize`` on the global minibatch (rank
  0's block, then rank 1's, along the env axis): gradients at rtol=1e-4,
  atol=1e-5 × the largest gradient, parameters and loss terms
  allclose(rtol=1e-4, atol=1e-5); across the ranks, parameters bit for bit;
- the KL stop: the minibatch it trips on and ``skipped`` exactly;
- the layout: the global minibatches equal JAX's, env for env;
- world 1 against the single-device step: parameters and metrics
  allclose(rtol=1e-5, atol=1e-6).
"""
import importlib
import pickle
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from megastep_tpu_torch import floorplans, interop, spaces, tracing
from megastep_tpu_torch.arrdict import arrdict
from megastep_tpu_torch.demo import learning
from megastep_tpu_torch.dotdict import dotdict
from megastep_tpu_torch.envs import Explorer
from megastep_tpu_torch.models import Agent
from megastep_tpu_torch.parallel import host, scaling
from megastep_tpu_torch.rebar import processes

train = importlib.import_module('megastep_tpu_torch.demo.train')
pmesh = importlib.import_module('megastep_tpu_torch.parallel.mesh')

torch.set_num_threads(1)

WORLD, JOIN_S = 2, 600
OBS_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
SEED, N_SPAWNS, STEPS = 3, 100, 3
# Per-rank builds: Explorer as tests/test_torch_explorer.py runs it, Deathmatch
# as tests/test_multihost.py:69-97 does.
EX_ENVS, EX_RES, EX_SUB = 16, 64, 4
DM_SCENES, DM_AGENTS, DM_RES, DM_SUB = 8, 4, 128, 2
# The learner: a (T, 2 * B_LOCAL) chunk, minibatches of LW envs a rank.
T, B_LOCAL, LW, W, WIDTH = 8, 12, 4, 64, 32
# The full sharded steps (tests/multihost_worker.py:54-80).
TRAIN = dict(buffer_size=3, batch_size=24)
DM_TRAIN = dict(buffer_size=3, batch_size=3 * DM_SCENES * DM_AGENTS // 2)


def _spaces(sp, dd):
    return (dd(rgb=sp.MultiImage(1, 3, 1, W), d=sp.MultiImage(1, 1, 1, W),
               imu=sp.MultiVector(1, 3)),
            sp.MultiDiscrete(1, 7))


def _obs(rs, *lead):
    return dict(rgb=rs.rand(*lead, 1, 3, 1, W).astype(np.float32),
                d=rs.rand(*lead, 1, 1, 1, W).astype(np.float32),
                imu=rs.randn(*lead, 1, 3).astype(np.float32))


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _to_torch(tree):
    return arrdict({k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
                    for k, v in tree.items()})


def _block(tree, r, axis):
    """Rank ``r``'s envs of a global numpy tree, along ``axis``."""
    sl = (slice(None),) * axis + (slice(r * B_LOCAL, (r + 1) * B_LOCAL),)
    return {k: _block(v, r, axis) if isinstance(v, dict) else v[sl] for k, v in tree.items()}


def _agent(params):
    return interop.agent_params_from_numpy(
        params, Agent(*_spaces(spaces, dotdict), width=WIDTH))


def _named(agent, attr=None):
    return {k: (p if attr is None else getattr(p, attr)).detach().numpy().copy()
            for k, p in agent.named_parameters()}


def _trajectory(env, actions, choices):
    """A reset and ``len(actions)`` steps with the given draws, as numpy."""
    state, world = env.reset(torch.from_numpy(choices[0]))
    out = [(state, world)]
    for a, c in zip(actions, choices[1:]):
        state, world = env.step(state, arrdict(actions=torch.from_numpy(a)),
                                torch.from_numpy(c))
        out.append((state, world))
    return [dict(obs={k: v.numpy() for k, v in w.obs.items()}, reward=w.reward.numpy(),
                 reset=w.reset.numpy(), seen=s.seen.numpy() if 'seen' in s else None)
            for s, w in out]


def _scenery(env):
    scn = env.core.scenery
    return {k: getattr(scn, k).numpy() for k in interop.SCENERY_FIELDS}


def _sharded_run(m, env, width, kwargs, chunks=2):
    """Chunks of the sharded step: each chunk's metrics, parameter digest and
    collective counts, by kind."""
    agent = Agent(env.obs_space, env.action_space, width=width,
                  generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(10 + m.rank)
    carry, step = pmesh.init_sharded(env, agent, train.optimizer(agent.parameters()), g,
                                     m, **kwargs)
    out = []
    for _ in range(chunks):
        m.counts.clear()
        carry, metrics = step(carry, g)
        out.append(dict(metrics=metrics, digest=pmesh.digest(agent.parameters()),
                        counts=dict(m.counts)))
    return dict(n_envs=env.n_envs, chunks=out)


def _rank(rank, store, inputs, out_dir):
    """One gloo rank: every two-rank check, its results pickled to
    ``out_dir/rank<r>.pkl``."""
    torch.set_num_threads(1)
    with processes.processgroup('gloo', f'file://{store}', WORLD, rank):
        m = pmesh.mesh('cpu')
        res = dict(consensus=(processes.consensus(True), processes.consensus(rank == 0)))

        ex = host.sharded_explorer(EX_ENVS, m, floorplans.sample(EX_ENVS, seed=7),
                                   seed=SEED, res=EX_RES, subsample=EX_SUB)
        res['explorer'] = dict(scenery=_scenery(ex), scene_order=np.array(ex.scene_order),
                               traj=_trajectory(ex, inputs['ex_actions'][rank],
                                                inputs['ex_choices'][rank]))
        dm = host.sharded_deathmatch(DM_SCENES * DM_AGENTS, m,
                                     floorplans.sample(DM_SCENES, seed=3), n_agents=DM_AGENTS,
                                     seed=SEED, res=DM_RES, subsample=DM_SUB)
        res['deathmatch'] = dict(scenery=_scenery(dm), scene_order=np.array(dm.scene_order),
                                 traj=_trajectory(dm, inputs['dm_actions'][rank],
                                                  inputs['dm_choices'][rank]))

        # The learner: one minibatch step through optimize on this rank's block.
        chunk = _to_torch(_block(inputs['chunk'], rank, 1))
        state0 = _to_torch(_block(inputs['state0'], rank, 0))
        batches = train.minibatches(torch.from_numpy(inputs['perm']), B_LOCAL // LW, LW)
        agent = _agent(inputs['params'])
        batch = chunk.map(lambda x: x[:, batches[0]])
        s0 = state0.map(lambda x: x[batches[0]])
        with torch.no_grad():
            d, _ = agent(batch.world, s0, value=True)
        adv = learning.generalized_advantages(d.value, batch.world.reward, d.value,
                                              batch.world.reset, gamma=.99)
        m.counts.clear()
        aux = train.optimize(agent, train.optimizer(agent.parameters()), batch, s0, mesh=m)
        res['learner'] = dict(aux={k: float(v) for k, v in aux.items()},
                              params=_named(agent), grads=_named(agent, 'grad'),
                              digest=pmesh.digest(agent.parameters()),
                              counts=dict(m.counts), local_adv=(float(adv.mean()),
                                                                float(adv.std(correction=0))))

        # The KL stop, over all of this rank's minibatches.
        # Traced, and given a graph, which the mesh path leaves unused.
        agent = _agent(inputs['params'])
        tracing.enable()
        try:
            metrics = train.learn(agent, train.optimizer(agent.parameters()), chunk, state0,
                                  batches, inputs['kl_limit'], mesh=m, graph=train.LossGraph())
        finally:
            tracing.disable()
        rec = tracing.drain()
        res['kl'] = dict(metrics={k: float(v) for k, v in metrics.items()},
                         params=_named(agent), digest=pmesh.digest(agent.parameters()),
                         spans=[s['name'] for s in rec['spans']], counts=rec['counts'])

        # The full sharded train steps, and the scaling harness's rank body.
        ex = host.sharded_explorer(EX_ENVS, m, floorplans.sample(EX_ENVS, seed=7),
                                   res=64, subsample=1)
        res['train_explorer'] = _sharded_run(m, ex, 16, TRAIN)
        dm = host.sharded_deathmatch(DM_SCENES * DM_AGENTS, m,
                                     floorplans.sample(DM_SCENES, seed=3),
                                     n_agents=DM_AGENTS, res=DM_RES, subsample=DM_SUB)
        res['train_deathmatch'] = _sharded_run(m, dm, 32, DM_TRAIN)
        res['rate'] = scaling.rank_rate(m, EX_ENVS, width=16, buffer_size=3, steps=1,
                                        res=64, subsample=1)
    (Path(out_dir) / f'rank{rank}.pkl').write_bytes(pickle.dumps(res))


class JaxSide:
    """The JAX package, imported here only (the ranks import this module)."""

    def __init__(self):
        import jax
        import jax.numpy as jnp
        from megastep_tpu import floorplans as jfloorplans, scene as jscene
        from megastep_tpu import spaces as jspaces
        from megastep_tpu.arrdict import arrdict as jarrdict
        from megastep_tpu.dotdict import dotdict as jdotdict
        from megastep_tpu.envs import Deathmatch as JDeathmatch, Explorer as JExplorer
        from megastep_tpu.models import Agent as JAgent
        self.jax, self.jnp, self.floorplans, self.scene = jax, jnp, jfloorplans, jscene
        self.arrdict, self.Explorer, self.Deathmatch = jarrdict, JExplorer, JDeathmatch
        self.train = importlib.import_module('megastep_tpu.demo.train')
        self.agent = JAgent(*_spaces(jspaces, jdotdict), width=WIDTH)
        self.apply = lambda p, w, s, **kw: self.agent.apply({'params': p}, w, s, **kw)

    def tree(self, tree):
        return self.arrdict({k: self.tree(v) if isinstance(v, dict) else self.jnp.asarray(v)
                             for k, v in tree.items()})

    def choices(self, seed, shape):
        """Each step's spawn draws, as the JAX env draws them from its key."""
        key = self.jax.random.PRNGKey(seed)
        keys = [key] + [self.jax.random.fold_in(key, t) for t in range(STEPS)]
        return keys, [np.asarray(self.jax.random.randint(k, shape, 0, N_SPAWNS)) for k in keys]

    def local_envs(self, kind):
        """Each rank's env, built as the JAX package's sharded builders build
        it locally, and the rank's slice of the scene order."""
        if kind == 'explorer':
            geoms, n_agents, n = self.floorplans.sample(EX_ENVS, seed=7), 1, EX_ENVS
            make = lambda n_local, gs, **kw: self.Explorer(  # noqa: E731
                n_local, geometries=gs, res=EX_RES, subsample=EX_SUB, **kw)
        else:
            geoms, n_agents, n = self.floorplans.sample(DM_SCENES, seed=3), DM_AGENTS, DM_SCENES
            make = lambda n_local, gs, **kw: self.Deathmatch(  # noqa: E731
                n_local * DM_AGENTS, n_agents=DM_AGENTS, geometries=gs, res=DM_RES,
                subsample=DM_SUB, **kw)
        pad = self.scene.padded_sizes(geoms, n_agents=n_agents)
        order = self.scene.striped_order(geoms, n_agents, WORLD)
        ordered = [geoms[i] for i in order]
        n_local = n // WORLD
        envs = []
        for r in range(WORLD):
            env = make(n_local, ordered[r * n_local:(r + 1) * n_local], pad_to=pad,
                       random=np.random.RandomState(SEED + r), sort_scenes=False,
                       obs_groups=1, fused=False)
            env.scene_order = order
            envs.append(env)
        return envs, pad

    def trajectory(self, env, keys, actions, reset, step):
        state, world = reset(env, keys[0])
        out = [(state, world)]
        for a, k in zip(actions, keys[1:]):
            state, world = step(env, state, self.arrdict(actions=self.jnp.asarray(a)), k)
            out.append((state, world))
        return [dict(obs={k: np.asarray(v) for k, v in w.obs.items()},
                     reward=np.asarray(w.reward), reset=np.asarray(w.reset),
                     seen=np.asarray(s.seen) if 'seen' in s else None) for s, w in out]

    def learner_inputs(self):
        """The flax agent's parameters, a global (T, 2 * B_LOCAL) chunk, a busy
        start state, and the permutation of a rank's envs that JAX's
        ``k_perm`` gives. The chunk's decisions are the agent's own (so the
        first minibatch's ratio is 1), except that the envs of minibatch 1
        took their action with probability ~1, which puts that minibatch's
        ``kl_div`` far above the others'. Rank 1's rewards are shifted by +3."""
        jax = self.jax
        perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(5), B_LOCAL))
        rs = np.random.RandomState(11)
        B = WORLD * B_LOCAL
        init = jax.jit(lambda key, w, s: self.agent.init(key, w, s, value=True))
        world1 = self.tree(dict(obs=_obs(rs, 1, 2), reset=np.zeros((1, 2), bool)))
        params = init(jax.random.PRNGKey(1), world1, self.agent.initial_state(2))['params']
        reward = rs.randn(T, B).astype(np.float32)
        reward[:, B_LOCAL:] += 3
        world = dict(obs=_obs(rs, T, B), reward=reward, reset=rs.rand(T, B) < .2)
        warm = dict(obs=_obs(rs, T, B), reset=rs.rand(T, B) < .2)
        run = jax.jit(lambda w, s: self.apply(params, w, s, value=True))
        _, state0 = run(self.tree(warm), self.agent.initial_state(B))
        d, _ = run(self.tree(world), state0)
        actions = rs.randint(0, 7, (T, B, 1))
        logits = np.array(d.logits)
        sure = np.where(np.arange(7) == actions[..., None], 0., -30.).astype(np.float32)
        kl_envs = self.global_batches(perm)[1]
        logits[:, kl_envs] = sure[:, kl_envs]
        chunk = dict(world=world, decision=dict(logits=logits, value=np.asarray(d.value),
                                                actions=actions))
        return _numpy(params), chunk, _numpy(state0), perm

    def global_batches(self, perm):
        """Global minibatch ``b``: rank 0's block, then rank 1's."""
        local = perm[:B_LOCAL // LW * LW].reshape(-1, LW)
        return [np.concatenate([r * B_LOCAL + b for r in range(WORLD)]) for b in local]

    def learner(self, params, chunk, state0, batches, kl_limit):
        """JAX ``optimize`` over the global minibatches, with the KL stop: the
        parameters, each run minibatch's loss terms, and ``skipped``."""
        jax, jnp = self.jax, self.jnp
        opt = self.train.optimizer()
        params = jax.tree_util.tree_map(jnp.asarray, params)
        opt_state = opt.init(params)
        jchunk, jstate0 = self.tree(chunk), self.tree(state0)
        take = lambda tree, idx, axis: jax.tree_util.tree_map(  # noqa: E731
            lambda x: jnp.take(x, jnp.asarray(idx), axis=axis), tree)
        if not hasattr(self, '_optimize'):
            self._optimize = jax.jit(
                lambda p, o, b, s: self.train.optimize(self.apply, opt, p, o, b, s))
        dead, auxs, flags = False, [], []
        for idx in batches:
            if not dead:
                params, opt_state, aux = self._optimize(params, opt_state,
                                                        take(jchunk, idx, 1),
                                                        take(jstate0, idx, 0))
                auxs.append({k: float(v) for k, v in aux.items()})
                dead = auxs[-1]['kl_div'] > kl_limit
            flags.append(float(dead))
        return _numpy(params), auxs, float(np.mean(flags))

    def gradients(self, params, chunk, state0, idx):
        jax = self.jax
        take = lambda tree, axis: jax.tree_util.tree_map(  # noqa: E731
            lambda x: self.jnp.take(x, self.jnp.asarray(idx), axis=axis), tree)
        loss = lambda p, c, s: self.train.ppo_loss(self.apply, p, c, s)  # noqa: E731
        (_, _), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jax.tree_util.tree_map(self.jnp.asarray, params), take(self.tree(chunk), 1),
            take(self.tree(state0), 0))
        return _numpy(grads)


def _kl_trip(kls):
    """The first minibatch whose ``kl_div`` exceeds every earlier one's, and a
    limit halfway between: the stop trips there and not before."""
    for k in range(1, len(kls)):
        if kls[k] > max(kls[:k]) + 1e-3 * abs(kls[k]):
            return k, (max(kls[:k]) + kls[k]) / 2
    raise AssertionError(f'no minibatch trips a stop: {kls}')


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """Both ranks' results, and the JAX references."""
    pytest.importorskip('megastep_tpu.demo.train')
    jx = JaxSide()
    tmp = tmp_path_factory.mktemp('ranks')
    rs = np.random.RandomState(4)
    ex_keys = [jx.choices(20 + r, (EX_ENVS // WORLD, 1)) for r in range(WORLD)]
    dm_keys = [jx.choices(30 + r, (DM_SCENES // WORLD, DM_AGENTS)) for r in range(WORLD)]
    ex_actions = rs.randint(0, 7, (WORLD, STEPS, EX_ENVS // WORLD, 1))
    dm_actions = rs.randint(0, 7, (WORLD, STEPS, DM_SCENES * DM_AGENTS // WORLD, 1))
    params, chunk, state0, perm = jx.learner_inputs()
    batches = jx.global_batches(perm)
    _, free, _ = jx.learner(params, chunk, state0, batches, np.inf)
    trip, kl_limit = _kl_trip([a['kl_div'] for a in free])
    inputs = dict(ex_actions=ex_actions, ex_choices=[c for _, c in ex_keys],
                  dm_actions=dm_actions, dm_choices=[c for _, c in dm_keys],
                  params=params, chunk=chunk, state0=state0, perm=perm, kl_limit=kl_limit)

    ctx = torch.multiprocessing.spawn(_rank, args=(str(tmp / 'store'), inputs, str(tmp)),
                                      nprocs=WORLD, join=False)
    try:
        # The JAX references, while the ranks run.
        reset = jx.jax.jit(lambda env, k: env.reset(k))
        step = jx.jax.jit(lambda env, s, d, k: env.step(s, d, k))
        ref = dotdict(trip=trip, kl_limit=kl_limit, params=params, batches=batches)
        for kind, keys, actions in (('explorer', ex_keys, ex_actions),
                                    ('deathmatch', dm_keys, dm_actions)):
            envs, pad = jx.local_envs(kind)
            ref[kind] = dotdict(pad=pad, envs=[dict(
                scenery={k: np.asarray(getattr(e.core.scenery, k))
                         for k in interop.SCENERY_FIELDS},
                scene_order=np.asarray(e.scene_order),
                traj=jx.trajectory(e, keys[r][0], actions[r], reset, step))
                for r, e in enumerate(envs)])
        ref['learner'] = jx.learner(params, chunk, state0, batches[:1], np.inf)
        ref['grads'] = jx.gradients(params, chunk, state0, batches[0])
        ref['kl'] = jx.learner(params, chunk, state0, batches, kl_limit)
        deadline = time.monotonic() + JOIN_S
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
            if time.monotonic() >= deadline:
                pytest.fail(f'the gloo ranks did not finish in {JOIN_S} s')
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    res = [pickle.loads((tmp / f'rank{r}.pkl').read_bytes()) for r in range(WORLD)]
    return res, ref


def _jax_params_by_port_name(params, agent_params):
    """The JAX parameters in the port's names (through ``interop``)."""
    return _named(interop.agent_params_from_numpy(params, _agent(agent_params)))


@pytest.mark.parametrize('kind', ['explorer', 'deathmatch'])
def test_per_rank_builds_match_jax(ranks, kind):
    res, ref = ranks
    pad = ref[kind].pad
    local_pads = set()
    for r in range(WORLD):
        got, want = res[r][kind], ref[kind].envs[r]
        for k in interop.SCENERY_FIELDS:
            a, b = got['scenery'][k], want['scenery'][k]
            assert a.dtype == b.dtype, k
            if k == 'baked':
                np.testing.assert_allclose(a, b, **OBS_TOL, err_msg=k)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f'rank {r}: {k}')
        np.testing.assert_array_equal(got['scene_order'], want['scene_order'])
        scn = got['scenery']
        assert (scn['lines'].shape[1], scn['lights'].shape[1], scn['baked'].shape[1]) == pad
        local_pads.add(int(scn['tex_width'].max()))
        for t, (a, b) in enumerate(zip(got['traj'], want['traj'])):
            for k in b['obs']:
                np.testing.assert_allclose(a['obs'][k], b['obs'][k], **OBS_TOL,
                                           err_msg=f'rank {r}, step {t}: {k}')
            np.testing.assert_allclose(a['reward'], b['reward'], **OBS_TOL)
            np.testing.assert_array_equal(a['reset'], b['reset'])
            if kind == 'explorer':
                # The Queue 3 trap: the seen mask spans the padded texel width.
                assert a['seen'].shape[1] == pad[2]
                np.testing.assert_array_equal(a['seen'], b['seen'])
    # The ranks' own texel maxima differ, so the shared padding was needed.
    assert len(local_pads) == WORLD, local_pads


def test_two_rank_learner_step_matches_jax_on_the_global_minibatch(ranks):
    res, ref = ranks
    a, b = (res[r]['learner'] for r in range(WORLD))
    # Rank 1's advantages sit far from rank 0's, their means further apart
    # than the global standard deviation: normalising by a rank's own
    # statistics would move every normalised advantage by more than half of one.
    (m0, _), (m1, _) = a['local_adv'], b['local_adv']
    assert abs(m1 - m0) > a['aux']['adv_std'], (a['local_adv'], b['local_adv'], a['aux'])
    assert a['digest'] == b['digest']
    assert a['aux'] == b['aux']
    assert a['counts'] == {'all_reduce': 4}
    jparams, (jaux,), _ = ref['learner']
    for k in jaux:
        np.testing.assert_allclose(a['aux'][k], jaux[k], **TOL, err_msg=k)
    want = _jax_params_by_port_name(jparams, ref['params'])
    for k, v in a['params'].items():
        np.testing.assert_allclose(v, want[k], **TOL, err_msg=k)
    grads = _jax_params_by_port_name(ref['grads'], ref['params'])
    scale = max(float(np.abs(g).max()) for g in grads.values())
    for k, g in a['grads'].items():
        np.testing.assert_allclose(g, grads[k], rtol=TOL['rtol'], atol=TOL['atol'] * scale,
                                   err_msg=k)


def test_kl_stop_trips_on_the_same_minibatch_as_jax(ranks):
    res, ref = ranks
    a, b = (res[r]['kl'] for r in range(WORLD))
    n = len(ref['batches'])
    jparams, jauxs, jskipped = ref['kl']
    assert len(jauxs) == ref['trip'] + 1 < n
    assert a['metrics']['minibatches'] == b['metrics']['minibatches'] == len(jauxs)
    assert jskipped == (n - ref['trip']) / n
    assert a['metrics']['skipped'] == b['metrics']['skipped'] == np.float32(jskipped)
    assert a['digest'] == b['digest']
    for k in jauxs[0]:
        np.testing.assert_allclose(a['metrics'][k], np.mean([x[k] for x in jauxs]), **TOL,
                                   err_msg=k)
    want = _jax_params_by_port_name(jparams, ref['params'])
    for k, v in a['params'].items():
        np.testing.assert_allclose(v, want[k], **TOL, err_msg=k)


def test_the_mesh_learner_records_the_eager_spans(ranks):
    """On the mesh path ``learn`` runs the eager loop of ``optimize`` even when
    given a ``LossGraph``: each minibatch that ran records ``learn.forward``,
    ``learn.backward``, ``learn.optimizer`` and ``learn.kl_read``, and there is
    no ``learn.graph`` and no graph counter."""
    res, _ = ranks
    for r in range(WORLD):
        kl = res[r]['kl']
        ran = int(kl['metrics']['minibatches'])
        assert {n: kl['spans'].count(n) for n in set(kl['spans'])} == {
            'learn.forward': ran, 'learn.backward': ran, 'learn.optimizer': ran,
            'learn.kl_read': ran}
        assert kl['counts'] == {'host_syncs': ran}


@pytest.mark.parametrize('kind', ['train_explorer', 'train_deathmatch'])
def test_full_sharded_step_at_world_two(ranks, kind):
    res, _ = ranks
    a, b = (res[r][kind] for r in range(WORLD))
    n_envs = EX_ENVS if kind == 'train_explorer' else DM_SCENES * DM_AGENTS
    assert a['n_envs'] == b['n_envs'] == n_envs // WORLD
    for x, y in zip(a['chunks'], b['chunks']):
        assert x['digest'] == y['digest']
        assert x['metrics'] == y['metrics'] and train.is_finite(x['metrics'])
        assert x['metrics']['samples'] == n_envs * 3
        want = pmesh.chunk_collectives(int(x['metrics']['minibatches']))
        assert x['counts'] == y['counts'] == dict(want)
    assert a['chunks'][0]['digest'] != a['chunks'][1]['digest']


def test_consensus_and_the_scaling_rank_body(ranks):
    res, _ = ranks
    assert [r['consensus'] for r in res] == [(True, False)] * WORLD
    assert all(r['rate'] > 0 for r in res)
    assert processes.consensus(True) is True and processes.consensus(False) is False


def test_layout_matches_jax_shard_local_blocks():
    """The JAX sharded step's blocks (``megastep_tpu/demo/train.py:170-187``,
    taken from the step's closure) on a chunk whose entries name their env,
    against the port's rank-local minibatches gathered here over the ranks."""
    from types import SimpleNamespace
    pytest.importorskip('megastep_tpu.demo.train')
    import jax
    import jax.numpy as jnp
    from megastep_tpu.parallel.mesh import mesh as jmesh
    jtrain = importlib.import_module('megastep_tpu.demo.train')

    n_envs, T_ = EX_ENVS, TRAIN['buffer_size']
    step = jtrain.make_train_step(SimpleNamespace(n_envs=n_envs), None, None,
                                  shard_mesh=jmesh(WORLD), **TRAIN)
    cells = dict(zip(step.__code__.co_freevars, (c.cell_contents for c in step.__closure__)))
    envs = np.arange(n_envs, dtype=np.int32)
    chunk = dict(x=100 * envs[None] + np.arange(T_, dtype=np.int32)[:, None])
    state0 = dict(h=envs)
    k_perm = jax.random.PRNGKey(5)
    cb, sb = cells['shard_local_batches'](
        jax.tree_util.tree_map(jnp.asarray, chunk), jax.tree_util.tree_map(jnp.asarray, state0),
        k_perm)
    perm = torch.from_numpy(np.array(jax.random.permutation(k_perm, n_envs // WORLD)))
    width = TRAIN['batch_size'] // T_
    n_batches, n_local = n_envs // width, n_envs // WORLD
    batches = train.minibatches(perm, n_batches, width // WORLD)
    for b in range(n_batches):
        got_x = np.concatenate([chunk['x'][:, r * n_local:(r + 1) * n_local][:, batches[b]]
                                for r in range(WORLD)], 1)
        got_h = np.concatenate([state0['h'][r * n_local:(r + 1) * n_local][batches[b]]
                                for r in range(WORLD)])
        np.testing.assert_array_equal(got_x, np.asarray(cb['x'][b]))
        np.testing.assert_array_equal(got_h, np.asarray(sb['h'][b]))


def _world_one(store, backend, device):
    """Two chunks of the sharded step over a one-rank group and of the
    single-device step, from the same seeds: each run's metrics and
    parameters."""
    env = Explorer(8, geometries=floorplans.sample(8, seed=7), res=64, subsample=1,
                   random=np.random.RandomState(0), device=device)
    runs = []
    with processes.processgroup(backend, f'file://{store}', 1, 0):
        m = pmesh.mesh(device)
        assert (m.rank, m.world) == (0, 1)
        for sharded in (True, False):
            agent = Agent(env.obs_space, env.action_space, width=16,
                          generator=torch.Generator().manual_seed(0)).to(device)
            opt = train.optimizer(agent.parameters())
            g = torch.Generator(device).manual_seed(1)
            kw = dict(buffer_size=3, batch_size=12)
            if sharded:
                carry, step = pmesh.init_sharded(env, agent, opt, g, m, perm_generator=g, **kw)
            else:
                carry, step = train.init_carry(env, agent, opt, g), train.make_train_step(env, **kw)
            history = []
            for _ in range(2):
                carry, metrics = step(carry, g)
                history.append(metrics)
            runs.append((history, {k: v.detach().cpu().numpy()
                                   for k, v in agent.named_parameters()}))
    return runs


def _same_runs(runs):
    (hs, ps), (h, p) = runs
    for x, y in zip(hs, h):
        assert x.keys() == y.keys() and x['minibatches'] == 2
        for k in x:
            np.testing.assert_allclose(x[k], y[k], **OBS_TOL, err_msg=k)
    for k in p:
        np.testing.assert_allclose(ps[k], p[k], **OBS_TOL, err_msg=k)


def test_world_one_matches_the_single_device_step(tmp_path):
    """At a world of one the sharded step (its collectives copies, its layout
    the single-device one) equals ``make_train_step`` without a mesh, from the
    same carry and generator."""
    _same_runs(_world_one(tmp_path / 'store', 'gloo', 'cpu'))


@pytest.mark.cuda
def test_world_one_over_nccl_on_the_card(tmp_path):
    """The same over a one-rank NCCL group on the card, with cuDNN's
    deterministic algorithms: its default weight gradient sums with atomics,
    so that two single-device runs would differ in the last bits."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _same_runs(_world_one(tmp_path / 'store', 'nccl', 'cuda'))
    finally:
        torch.backends.cudnn.deterministic = saved


def test_mesh_needs_a_group_and_a_width_that_splits():
    with pytest.raises(RuntimeError, match='no process group'):
        pmesh.mesh('cpu')
    m = pmesh.Mesh(0, 3, torch.device('cpu'))
    env = Explorer(8, geometries=floorplans.sample(8, seed=7), res=64, subsample=1,
                   device='cpu')
    with pytest.raises(ValueError, match='multiple of'):
        train.make_train_step(env, mesh=m, **TRAIN)
    with pytest.raises(ValueError, match='split evenly'):
        host.process_slice(10, m)


def test_scaling_main_arithmetic(monkeypatch, capsys):
    """``main()``'s efficiency line, as ``tests/test_scaling.py:39-48`` checks
    JAX's; with one device it prints the rate alone."""
    calls = []

    def measure(n_envs, n_devices=None, **kw):
        calls.append((n_envs, n_devices, kw))
        return dict(steps_per_s=1000. if (n_devices or 4) > 1 else 300.,
                    n_devices=n_devices or 4, n_envs=n_envs)
    monkeypatch.setattr(scaling, 'measure', measure)
    scaling.main(['--envs', '64', '--batch', '32'])
    out = capsys.readouterr().out
    assert '4 devices: 1,000 steps/s -> scaling efficiency 83.3%' in out
    assert calls[1][:2] == (16, 1) and calls[1][2]['batch_size'] == 8
    scaling.main(['--envs', '64', '--devices', '1'])
    out = capsys.readouterr().out
    assert out.strip() == '1 device: 300 steps/s'


def test_scaling_needs_a_gpu_a_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(ValueError, match='NCCL takes one GPU a rank'):
        scaling.measure(16, n_devices=2)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 0)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        scaling.measure(16)
