"""The port's training step (``megastep_tpu_torch.demo.train``) and FSM testbeds
(``megastep_tpu_torch.rebar.fsm``) against the JAX package's, on the CPU.

Tolerances:
- the optimizer against ``optax.chain(clip_by_global_norm(100), amsgrad(3e-4))``
  over 10 given gradients, one of them exploding: parameters allclose(rtol=1e-5,
  atol=1e-6) after every step;
- ``ppo_loss``'s value and terms: allclose(rtol=1e-4, atol=1e-5); its gradients
  against ``jax.value_and_grad``: rtol=1e-4, atol=1e-5 × the largest gradient
  magnitude;
- the learner loop (the KL stop tripped, and not) against JAX ``optimize``
  calls over the same permutation: parameters and every metric
  allclose(rtol=1e-4, atol=1e-5), ``skipped`` exactly;
- a rollout of a small Explorer (res 64, subsample 1, 4 envs, T=6): the
  observations and rewards allclose(rtol=1e-5, atol=1e-6), resets and actions
  exactly (the converted ``policy_out`` bias holds +1e4 on one action, so both
  packages sample it), logits and values allclose(rtol=1e-4, atol=1e-5);
- FSM tables and ``solve`` exactly, for all eight testbeds.

The ``cuda`` cases need no JAX; they skip without a GPU.
"""
import importlib

import numpy as np
import pytest
import torch

from megastep_tpu_torch import interop, spaces
from megastep_tpu_torch.arrdict import arrdict
from megastep_tpu_torch.dotdict import dotdict
from megastep_tpu_torch.models import Agent
from megastep_tpu_torch.rebar import fsm

# The module, not the ``train`` function its package exports under that name.
train = importlib.import_module('megastep_tpu_torch.demo.train')

torch.set_num_threads(1)

OPT_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
OBS_TOL = dict(rtol=1e-5, atol=1e-6)
T, B, W, WIDTH = 8, 8, 64, 32
TESTBEDS = ('ObliviousConstantReward', 'ObliviousCyclicReward', 'ObliviousChain',
            'ObliviousCoin', 'ObliviousDelayedCoin', 'DelayedMatchCoin', 'MatchCoin',
            'RandomChain')


@pytest.fixture(scope='module')
def jx():
    pytest.importorskip('megastep_tpu.demo.train')
    import jax
    import jax.numpy as jnp
    import optax
    from megastep_tpu import floorplans, spaces as jspaces
    from megastep_tpu.arrdict import arrdict as jarrdict
    jtrain = importlib.import_module('megastep_tpu.demo.train')
    from megastep_tpu.dotdict import dotdict as jdotdict
    from megastep_tpu.envs import Explorer as JExplorer
    from megastep_tpu.models import Agent as JAgent
    from megastep_tpu.rebar import fsm as jfsm
    return dotdict(jax=jax, jnp=jnp, optax=optax, floorplans=floorplans, spaces=jspaces,
                   arrdict=jarrdict, dotdict=jdotdict, train=jtrain, Explorer=JExplorer,
                   Agent=JAgent, fsm=jfsm)


def _spaces(sp, dd):
    return (dd(rgb=sp.MultiImage(1, 3, 1, W), d=sp.MultiImage(1, 1, 1, W),
               imu=sp.MultiVector(1, 3)),
            sp.MultiDiscrete(1, 7))


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _to_jax(jx, tree):
    return jx.arrdict({k: _to_jax(jx, v) if isinstance(v, dict) else jx.jnp.asarray(v)
                       for k, v in tree.items()})


def _to_torch(tree):
    return arrdict({k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
                    for k, v in tree.items()})


def _agents(jx, core='lstm', width=WIDTH):
    """A flax agent, its params, and the port's agent holding the same params."""
    jobs, jact = _spaces(jx.spaces, jx.dotdict)
    jagent = jx.Agent(jobs, jact, width=width, core=core)
    world = _to_jax(jx, dict(obs=_obs(np.random.RandomState(0), 1, 2),
                             reset=np.zeros((1, 2), bool)))
    init = jx.jax.jit(lambda key, w, s: jagent.init(key, w, s, value=True))
    params = init(jx.jax.random.PRNGKey(1), world, jagent.initial_state(2))['params']
    obs_space, act = _spaces(spaces, dotdict)
    agent = interop.agent_params_from_numpy(
        _numpy(params), Agent(obs_space, act, width=width, core=core))
    return jagent, params, agent


def _obs(rs, *lead):
    return dict(rgb=rs.rand(*lead, 1, 3, 1, W).astype(np.float32),
                d=rs.rand(*lead, 1, 1, 1, W).astype(np.float32),
                imu=rs.randn(*lead, 1, 3).astype(np.float32))


def _chunk(jx, jagent, params, seed, own_logits):
    """A (T, B) rollout chunk and a busy start state, as numpy trees. With
    ``own_logits`` the decision's logits and values are the agent's own on the
    chunk (the first minibatch's case: ratio 1); otherwise random ones."""
    rs = np.random.RandomState(seed)
    world = dict(obs=_obs(rs, T, B), reward=rs.randn(T, B).astype(np.float32),
                 reset=rs.rand(T, B) < .2)
    warm = dict(obs=_obs(rs, T, B), reset=rs.rand(T, B) < .2)
    run = jx.jax.jit(lambda w, s: jagent.apply({'params': params}, w, s, value=True))
    _, state0 = run(_to_jax(jx, warm), jagent.initial_state(B))
    if own_logits:
        d, _ = run(_to_jax(jx, world), state0)
        logits, value = np.asarray(d.logits), np.asarray(d.value)
    else:
        logits = np.asarray(jx.jax.nn.log_softmax(rs.randn(T, B, 1, 7).astype(np.float32)))
        value = rs.randn(T, B).astype(np.float32)
    decision = dict(logits=logits, value=value, actions=rs.randint(0, 7, (T, B, 1)))
    return dict(world=world, decision=decision), _numpy(state0)


def _grads_close(agent, jgrads, ref_agent):
    """Each parameter's gradient against the JAX one, loaded into ``ref_agent``
    as if it were a parameter."""
    interop.agent_params_from_numpy(_numpy(jgrads), ref_agent)
    want = dict(ref_agent.named_parameters())
    scale = max(float(p.detach().abs().max()) for p in want.values())
    for name, p in agent.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].detach().numpy(),
                                   rtol=TOL['rtol'], atol=TOL['atol'] * scale, err_msg=name)


def _params_close(agent, jparams, ref_agent, tol=TOL):
    interop.agent_params_from_numpy(_numpy(jparams), ref_agent)
    want = dict(ref_agent.named_parameters())
    for name, p in agent.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].detach().numpy(), **tol,
                                   err_msg=name)


def test_clipped_amsgrad_matches_optax(jx):
    rs = np.random.RandomState(0)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    # The fourth gradient explodes (global norm ~1e6, clipped to 100).
    scales = [1., .1, 1e-3, 1e5, 1., 10., 1e-2, 1e3, 1., 1e-6]
    grads = [[(rs.randn(*s) * c).astype(np.float32) for s in shapes] for c in scales]
    opt = jx.optax.chain(jx.optax.clip_by_global_norm(100.), jx.optax.amsgrad(3e-4))
    jparams = [jx.jnp.asarray(p) for p in params]
    state = opt.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    topt = train.optimizer(tparams, lr=3e-4)
    for g in grads:
        updates, state = opt.update([jx.jnp.asarray(x) for x in g], state, jparams)
        jparams = jx.optax.apply_updates(jparams, updates)
        for p, x in zip(tparams, g):
            p.grad = torch.from_numpy(x.copy())
        topt.step()
        for p, q in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q), **OPT_TOL)
    # And it is not PyTorch's AMSGrad, which keeps the maximum of the raw moment.
    ref = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    adam = torch.optim.Adam(ref, lr=3e-4, amsgrad=True)
    for g in grads[4:]:
        for p, x in zip(ref, g):
            p.grad = torch.from_numpy(x.copy())
        adam.step()
    bare = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    mine = train.optimizer(bare, lr=3e-4, max_grad_norm=None)
    for g in grads[4:]:
        for p, x in zip(bare, g):
            p.grad = torch.from_numpy(x.copy())
        mine.step()
    assert max(float((a - b).detach().abs().max()) for a, b in zip(ref, bare)) > 1e-5


@pytest.mark.parametrize('core,own_logits', [('lstm', True), ('lstm', False),
                                             ('transformer', False)])
def test_ppo_loss_and_gradients_match_jax(jx, core, own_logits):
    jagent, params, agent = _agents(jx, core)
    chunk, state0 = _chunk(jx, jagent, params, 1, own_logits)
    apply = lambda p, w, s, **kw: jagent.apply({'params': p}, w, s, **kw)
    loss_fn = lambda p, c, s: jx.train.ppo_loss(apply, p, c, s)
    (jloss, jaux), jgrads = jx.jax.jit(jx.jax.value_and_grad(loss_fn, has_aux=True))(
        params, _to_jax(jx, chunk), _to_jax(jx, state0))
    loss, aux = train.ppo_loss(agent, _to_torch(chunk), _to_torch(state0))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]), **TOL, err_msg=k)
    ref = Agent(*_spaces(spaces, dotdict), width=WIDTH, core=core)
    _grads_close(agent, jgrads, ref)


def _jax_learner(jx, jagent, params, chunk, state0, batches, kl_limit):
    """The JAX package's learner, as a loop of ``optimize`` calls in the given
    order with its KL stop and metrics (``train.py:202-245``)."""
    apply = lambda p, w, s, **kw: jagent.apply({'params': p}, w, s, **kw)
    opt = jx.train.optimizer()
    opt_state = opt.init(params)
    jchunk, jstate0 = _to_jax(jx, chunk), _to_jax(jx, state0)
    take = lambda tree, idx, axis: jx.jax.tree_util.tree_map(
        lambda x: jx.jnp.take(x, jx.jnp.asarray(idx), axis=axis), tree)
    optimize = jx.jax.jit(lambda p, o, b, s: jx.train.optimize(apply, opt, p, o, b, s))
    dead, auxs, flags = False, [], []
    for idx in batches:
        if not dead:
            params, opt_state, aux = optimize(params, opt_state, take(jchunk, idx, 1),
                                              take(jstate0, idx, 0))
            auxs.append({k: float(v) for k, v in aux.items()})
            dead = auxs[-1]['kl_div'] > kl_limit
        flags.append(float(dead))
    metrics = {k: np.mean([a[k] for a in auxs]) for k in auxs[0]}
    metrics['skipped'] = np.mean(flags)
    return params, metrics


@pytest.mark.parametrize('kl_limit', [-1., 1e9])
def test_learner_matches_jax_with_the_kl_stop(jx, kl_limit):
    """With ``kl_limit=-1`` minibatch 0 trips the stop and no other runs
    (skipped = 1); with a limit never reached, all run (skipped = 0)."""
    jagent, params, agent = _agents(jx)
    chunk, state0 = _chunk(jx, jagent, params, 2, own_logits=True)
    batches = np.random.RandomState(3).permutation(B).reshape(2, B // 2)
    jparams, jmetrics = _jax_learner(jx, jagent, params, chunk, state0, batches, kl_limit)

    metrics = train.learn(agent, train.optimizer(agent.parameters()), _to_torch(chunk),
                          _to_torch(state0), torch.from_numpy(batches), kl_limit)
    assert set(metrics) == set(jmetrics) | {'minibatches'}
    assert float(metrics['skipped']) == jmetrics['skipped'] == (1. if kl_limit < 0 else 0.)
    assert int(metrics['minibatches']) == (1 if kl_limit < 0 else 2)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), jmetrics[k], **TOL, err_msg=k)
    _params_close(agent, jparams, Agent(*_spaces(spaces, dotdict), width=WIDTH))


def test_rollout_matches_jax_on_explorer(jx):
    """Four Explorer envs (res 64, no pooling) for T=6 steps: the policy bias on
    action 3 is +1e4 in both packages, so both sample it on every step."""
    from megastep_tpu_torch import floorplans
    from megastep_tpu_torch.envs import Explorer

    N, STEPS, N_SPAWNS = 4, 6, 100
    env = Explorer(N, geometries=floorplans.sample(N, seed=7), res=W, subsample=1,
                   random=np.random.RandomState(12), device='cpu')
    jenv = jx.Explorer(N, geometries=jx.floorplans.sample(N, seed=7), res=W, subsample=1,
                       fused=False, random=np.random.RandomState(12))
    jagent, params, _ = _agents(jx, width=16)
    params = _numpy(params)
    params['policy_out']['Dense_0']['bias'] = np.array([0, 0, 0, 1e4, 0, 0, 0], np.float32)
    agent = interop.agent_params_from_numpy(
        params, Agent(env.obs_space, env.action_space, width=16))
    jparams = jx.jax.tree_util.tree_map(jx.jnp.asarray, params)

    key = jx.jax.random.PRNGKey(3)
    jstate, jworld = jenv.reset(key)
    choices = torch.from_numpy(np.array(jx.jax.random.randint(key, (N, 1), 0, N_SPAWNS)))
    state, world = env.reset(choices)
    apply = lambda p, w, s, **kw: jagent.apply({'params': p}, w, s, **kw)
    rollout = jx.jax.jit(lambda e, p, s, w, a, k: jx.train.rollout(e, apply, p, s, w, a, k,
                                                                     STEPS))
    _, _, jagent_state, jchunk = rollout(jenv, jparams, jstate, jworld,
                                         jagent.initial_state(N), jx.jax.random.PRNGKey(4))
    _, _, agent_state, chunk = train.rollout(
        env, agent, state, world, agent.initial_state(N), torch.Generator().manual_seed(4),
        STEPS)

    np.testing.assert_array_equal(chunk.decision.actions.numpy(), 3)
    np.testing.assert_array_equal(np.asarray(jchunk.decision.actions), 3)
    for k in ('rgb', 'd', 'imu'):
        np.testing.assert_allclose(chunk.world.obs[k].numpy(), np.asarray(jchunk.world.obs[k]),
                                   **OBS_TOL, err_msg=k)
    np.testing.assert_allclose(chunk.world.reward.numpy(), np.asarray(jchunk.world.reward),
                               **OBS_TOL)
    np.testing.assert_array_equal(chunk.world.reset.numpy(), np.asarray(jchunk.world.reset))
    assert float(chunk.world.reward[1:].sum()) > 0, 'the agents should see new texels'
    for k in ('logits', 'value'):
        np.testing.assert_allclose(chunk.decision[k].numpy(), np.asarray(jchunk.decision[k]),
                                   **TOL, err_msg=k)
    for core in ('policy', 'value'):
        for k in ('h', 'c'):
            np.testing.assert_allclose(agent_state[core][k].numpy(),
                                       np.asarray(jagent_state[core][k]), **TOL)


@pytest.mark.parametrize('name', TESTBEDS)
def test_fsm_tables_and_solution_match_jax(jx, name):
    env = getattr(fsm, name)(4, device='cpu')
    jenv = getattr(jx.fsm, name)(4)
    for k in ('_obs', '_trans', '_reward', '_terminal', '_start'):
        np.testing.assert_array_equal(getattr(env, k).numpy(), np.asarray(getattr(jenv, k)),
                                      err_msg=k)
    assert env._indices == jenv._indices
    assert env.obs_space.shape == jenv.obs_space.shape
    assert env.action_space.shape == jenv.action_space.shape
    got, want = env.solve(), jenv.solve()
    np.testing.assert_array_equal(got.value, want.value)
    np.testing.assert_array_equal(got.policy, want.policy)


def test_fsm_steps_follow_the_tables():
    """MatchCoin: the reward is +1 for the matching action and -1 otherwise, and
    every step ends the episode and restarts from a start state."""
    env = fsm.MatchCoin(256, device='cpu')
    g = torch.Generator().manual_seed(0)
    state, world = env.reset(g)
    assert world.reset.all() and set(state.token.tolist()) == {0, 1}
    heads = state.token == 0
    actions = torch.where(heads, 0, 1)[:, None]
    actions[:128] = 1 - actions[:128]
    state, world = env.step(state, arrdict(actions=actions), g)
    assert torch.equal(world.reward, torch.where(torch.arange(256) < 128, -1., 1.))
    assert world.reset.all() and set(state.token.tolist()) == {0, 1}
    np.testing.assert_array_equal(world.obs[:, 0, 0].numpy(),
                                  np.where(state.token.numpy() == 0, 1., -1.))


def test_learns_match_coin():
    """As ``tests/test_train.py::test_learns_match_coin`` (width 16, AMSGrad at
    3e-3, buffer 8, 30 chunks): the last 5 chunks' mean trajectory reward must
    exceed 0.3, where random play gets 0."""
    env = fsm.MatchCoin(32, device='cpu')
    agent = Agent(env.obs_space, env.action_space, width=16,
                  generator=torch.Generator().manual_seed(0))
    opt = train.optimizer(agent.parameters(), lr=3e-3, max_grad_norm=None)
    g = torch.Generator().manual_seed(0)
    carry = train.init_carry(env, agent, opt, g)
    step = train.make_train_step(env, buffer_size=8, batch_size=8 * env.n_envs)
    rewards = []
    for _ in range(30):
        carry, metrics = step(carry, g)
        rewards.append(metrics['traj_reward'])
    assert np.mean(rewards[-5:]) > .3, rewards


def test_train_entry_point_on_the_cpu(tmp_path, monkeypatch):
    from megastep_tpu_torch.rebar import paths
    monkeypatch.setattr(paths, 'ROOT', str(tmp_path))  # train() writes a run directory
    carry, history = train.train(fsm.ObliviousCoin(8, device='cpu'), buffer_size=4,
                                 batch_size=16, width=8, steps=3)
    assert len(history) == 3 and all(train.is_finite(m) for m in history)
    assert history[-1]['minibatches'] == 2 and history[-1]['samples'] == 32
    assert carry.agent_state.policy.h.shape == (8, 8)
    with pytest.raises(ValueError, match='ZERO minibatches'):
        train.make_train_step(fsm.ObliviousCoin(8, device='cpu'), buffer_size=4,
                              batch_size=64)


@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
def test_forward_and_step_on_the_card_match_the_cpu(card):
    """The width-256 agent's forward, its gradients and one optimizer step, on
    the card and on the CPU from the same weights and inputs:
    allclose(rtol=1e-4, atol=1e-5), the gradients at atol 1e-5 × the largest
    one. TF32 in the card's convolutions or matmuls, forward or backward, would
    fail this."""
    obs_space, act = _spaces(spaces, dotdict)
    rs = np.random.RandomState(5)
    chunk = dict(world=dict(obs=_obs(rs, T, 64), reward=rs.randn(T, 64).astype(np.float32),
                            reset=rs.rand(T, 64) < .2))
    runs = {}
    for device in ('cpu', card):
        agent = Agent(obs_space, act, width=256,
                      generator=torch.Generator().manual_seed(0)).to(device)
        batch = _to_torch(chunk).map(lambda x: x.to(device))
        with torch.no_grad():
            d, _ = agent(batch.world, agent.initial_state(64), value=True)
        batch['decision'] = arrdict(logits=d.logits, value=d.value,
                                    actions=d.logits.argmax(-1))
        aux = train.optimize(agent, train.optimizer(agent.parameters()), batch,
                             agent.initial_state(64))
        runs[str(device)] = (d, aux, [p.grad.cpu() for p in agent.parameters()],
                             [p.detach().cpu() for p in agent.parameters()])
    (d, aux, gs, ps), (dc, auxc, gsc, psc) = runs['cpu'], runs['cuda']
    for k in ('logits', 'value'):
        torch.testing.assert_close(dc[k].cpu(), d[k], **TOL)
    torch.testing.assert_close(auxc['loss'].cpu(), aux['loss'], **TOL)
    scale = max(float(g.abs().max()) for g in gs)
    for g, h in zip(gsc, gs):
        torch.testing.assert_close(g, h, rtol=TOL['rtol'], atol=TOL['atol'] * scale)
    for p, q in zip(psc, ps):
        torch.testing.assert_close(p, q, **TOL)


@pytest.mark.cuda
def test_one_flagship_chunk_at_256_envs(card):
    """The flagship config (res 256 pooled by 4, width 256, buffer 32) at 256
    envs and two minibatches: one chunk, its metrics finite, and the observe
    kernel launched once per rollout step."""
    from megastep_tpu_torch.ops import fused
    from megastep_tpu_torch.perf import train_flagship

    run = train_flagship.build(n_envs=256, batch_size=32 * 128, device=card)
    fused.observe.launches = 0
    run['carry'], metrics = run.step(run.carry, run.generator)
    assert fused.observe.launches == 32
    assert train.is_finite(metrics) and metrics['minibatches'] >= 1


def _learn_traced(agent, opt, chunk, state0, batches, kl_limit, graph):
    from megastep_tpu_torch import tracing
    tracing.enable()
    try:
        metrics = train.learn(agent, opt, chunk, state0, batches, kl_limit, graph=graph)
    finally:
        tracing.disable()
    return metrics, tracing.drain()


#: A small hybrid core for the learner's tests: a Mamba, attention, Mamba
#: period, at widths that divide the agent's.
HYBRID = dict(layer_types=('mamba', 'attention', 'mamba'), mamba_n_heads=4, mamba_d_head=8,
              mamba_d_state=8, num_attention_heads=2, num_key_value_heads=1,
              shared_intermediate_size=32, mem_len=8)
#: The card's: published head, state and conv sizes at width 256.
HYBRID_CARD = dict(HYBRID, mamba_n_heads=8, mamba_d_head=64, mamba_d_state=128,
                   num_attention_heads=4, num_key_value_heads=2,
                   shared_intermediate_size=1024, mem_len=16)


@pytest.mark.parametrize('kl_limit', [1e9, -1.], ids=['every-minibatch', 'stop-after-first'])
@pytest.mark.parametrize('core', ['lstm', 'transformer', 'granite_hybrid'])
def test_the_cpu_learner_with_a_graph_is_the_eager_loop_of_optimize(core, kl_limit):
    """On the CPU, ``learn`` given a ``LossGraph`` runs the eager loop of
    ``optimize`` with its KL stop: the same bits in the parameters, the
    moments and the loss terms; per minibatch the eager spans and no
    ``learn.graph``; no graph counter; nothing captured."""
    env = fsm.MatchCoin(16, device='cpu')

    def agent_and_opt():
        agent = Agent(env.obs_space, env.action_space, width=16, core=core,
                      generator=torch.Generator().manual_seed(0),
                      core_config=HYBRID if core == 'granite_hybrid' else None)
        return agent, train.optimizer(agent.parameters())
    agent, opt = agent_and_opt()
    g = torch.Generator().manual_seed(0)
    state, world = env.reset(g)
    state0 = agent.initial_state(env.n_envs)
    _, _, _, chunk = train.rollout(env, agent, state, world, state0, g, 4)
    batches = train.minibatches(torch.randperm(env.n_envs, generator=g), 4, 4)
    graph = train.LossGraph()
    got, rec = _learn_traced(agent, opt, chunk, state0, batches, kl_limit, graph)

    ref, ref_opt = agent_and_opt()
    rows = []
    for idx in batches:
        rows.append(train.optimize(ref, ref_opt, chunk.map(lambda x: x[:, idx]),
                                   state0.map(lambda x: x[idx])))
        if rows[-1]['kl_div'] > kl_limit:
            break
    ran = len(rows)
    assert ran == (1 if kl_limit < 0 else 4) and float(got['minibatches']) == ran
    for k in rows[0]:
        assert torch.equal(got[k], torch.stack([r[k] for r in rows]).mean()), k
    assert all(torch.equal(p, q) for p, q in zip(agent.parameters(), ref.parameters()))
    mine, theirs = opt.state_dict(), ref_opt.state_dict()
    assert mine['count'] == theirs['count'] == ran
    for k in ('mu', 'nu', 'nu_max'):
        assert all(torch.equal(a, b) for a, b in zip(mine[k], theirs[k])), k
    # The hybrid core's own spans (one a mixer call) aside.
    names = [s['name'] for s in rec['spans'] if not s['name'].startswith('core.')]
    assert {n: names.count(n) for n in set(names)} == {
        'learn.forward': ran, 'learn.backward': ran, 'learn.optimizer': ran,
        'learn.kl_read': ran}
    assert rec['counts'] == {'host_syncs': ran}
    assert graph.graph is None and graph.key is None


def test_each_single_device_step_owns_its_graph_and_a_mesh_step_none(monkeypatch):
    """``make_train_step`` makes a ``LossGraph`` for each single-device step
    (none is shared between steps) and none with a mesh."""
    made = []

    class Seen(train.LossGraph):
        def __init__(self):
            super().__init__()
            made.append(self)
    monkeypatch.setattr(train, 'LossGraph', Seen)
    env = fsm.MatchCoin(8, device='cpu')
    train.make_train_step(env, buffer_size=4, batch_size=16)
    train.make_train_step(env, buffer_size=4, batch_size=16)
    assert len(made) == 2 and made[0] is not made[1]

    class OneRank:
        world = 1
    train.make_train_step(env, buffer_size=4, batch_size=16, mesh=OneRank())
    assert len(made) == 2


@pytest.fixture
def deterministic(card):
    """cuDNN's deterministic algorithms: without them the convolutions' weight
    gradients sum with atomics, and two runs part by rounding."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = saved


def _graph_and_eager(monkeypatch, core, kl_limit):
    """The flagship config at 256 envs, buffer 8, 4 minibatches of 64 env
    columns, built twice from one seed: a step on the graph path, and one
    whose learner is the eager loop of ``optimize`` (no ``LossGraph``)."""
    from megastep_tpu_torch import floorplans
    from megastep_tpu_torch.perf import train_flagship
    runs = []
    for graphed in (True, False):
        with monkeypatch.context() as m:
            if not graphed:
                m.setattr(train, 'LossGraph', lambda: None)
            run = train_flagship.build(
                n_envs=256, buffer_size=8, batch_size=8 * 64, core=core,
                core_config=HYBRID_CARD if core == 'granite_hybrid' else None,
                geometries=floorplans.sample(16), device='cuda')
            run['step'] = train.make_train_step(run.env, buffer_size=8, batch_size=8 * 64,
                                                kl_limit=kl_limit)
        runs.append(run)
    return runs


def _chunk_traced(run):
    from megastep_tpu_torch import tracing
    tracing.enable()
    try:
        run['carry'], metrics = run.step(run.carry, run.generator)
    finally:
        tracing.disable()
    return metrics, tracing.drain()


def _same_state(a, b):
    assert all(torch.equal(p, q) for p, q in zip(a.agent.parameters(), b.agent.parameters()))
    sa, sb = a.opt.state_dict(), b.opt.state_dict()
    assert sa['count'] == sb['count']
    for k in ('mu', 'nu', 'nu_max'):
        assert all(torch.equal(x, y) for x, y in zip(sa[k], sb[k])), k


@pytest.mark.cuda
@pytest.mark.parametrize('kl_limit', [.02, -1.], ids=['kl-stop-at-0.02', 'stop-after-first'])
@pytest.mark.parametrize('core', ['lstm', 'transformer', 'granite_hybrid'])
def test_graph_step_matches_the_eager_loop_bit_for_bit(deterministic, monkeypatch, core,
                                                       kl_limit):
    """Two chunks on the graph path and through the eager loop of
    ``optimize``, from the same state and draws: parameters, moments,
    ``count``, loss terms and ``minibatches`` equal bit for bit; one capture,
    and a replay for every minibatch that ran (with a limit of -1, only the
    first)."""
    graphed, eager = _graph_and_eager(monkeypatch, core, kl_limit)
    ran = 0
    for chunk in range(2):
        got, rec = _chunk_traced(graphed)
        want, ref = _chunk_traced(eager)
        assert got == want, chunk
        _same_state(graphed, eager)
        ran += int(got['minibatches'])
        if kl_limit < 0:
            assert got['minibatches'] == 1 and got['skipped'] == 1
        names = [s['name'] for s in rec['spans']]
        assert names.count('learn.graph') == got['minibatches']
        assert 'learn.graph' not in [s['name'] for s in ref['spans']]
        assert rec['counts'].get('learn_graph_captures', 0) == (1 if chunk == 0 else 0)
        assert rec['counts']['learn_graph_replays'] == got['minibatches']
        assert not {'learn_graph_captures', 'learn_graph_replays'} & set(ref['counts'])
    assert graphed.opt.count == ran


@pytest.mark.cuda
def test_graph_is_kept_through_load_state_dict(deterministic, monkeypatch):
    """After a chunk, both steps' agents load other weights in place: the
    graph is not captured again, and its next chunk, which follows the new
    weights, equals the eager loop's bit for bit."""
    graphed, eager = _graph_and_eager(monkeypatch, 'lstm', .02)
    for run in (graphed, eager):
        _chunk_traced(run)
    _same_state(graphed, eager)
    other = Agent(graphed.env.obs_space, graphed.env.action_space, width=256,
                  generator=torch.Generator().manual_seed(1)).state_dict()
    before = [p.detach().clone() for p in graphed.agent.parameters()]
    for run in (graphed, eager):
        run.agent.load_state_dict(other)
    got, rec = _chunk_traced(graphed)
    want, _ = _chunk_traced(eager)
    assert got == want
    _same_state(graphed, eager)
    assert 'learn_graph_captures' not in rec['counts']
    assert rec['counts']['learn_graph_replays'] == got['minibatches']
    # The update started from the loaded weights, not the earlier ones.
    loaded = [p.to(graphed.env.device) for p in other.values()]
    after = [p.detach() for p in graphed.agent.parameters()]
    moved = max(float((p - q).abs().max()) for p, q in zip(after, loaded))
    stale = max(float((p - q).abs().max()) for p, q in zip(after, before))
    assert moved < stale


def test_as_chunk_divides_through_div():
    """``step_reward`` is a true division by the sample count (``ops.geom.div``),
    at a count whose reciprocal is not exact."""
    from megastep_tpu_torch.ops.geom import div
    rs = np.random.RandomState(0)
    reward = torch.from_numpy(rs.rand(3, 7).astype(np.float32))
    reset = torch.from_numpy(rs.rand(3, 7) < .3)
    stats = train.as_chunk(arrdict(world=arrdict(reward=reward, reset=reset)))
    assert float(stats['samples']) == 21
    assert torch.equal(stats['step_reward'], div(reward.sum(), 21))
    assert torch.equal(stats['traj_reward'], reward.sum() / reset.sum().float())


def test_grad_noise_holds_one_device_to_itself_and_to_float64():
    """``perf/grad_noise.measure`` with the CPU as the card: the same device
    gives the same gradients bit for bit, reversed columns change only the
    order of the sums, and f32 lies within 1e-5 × the largest gradient of the
    float64 step (exact here: 8 columns of 4 steps)."""
    from megastep_tpu_torch import floorplans
    from megastep_tpu_torch.perf import grad_noise, train_flagship
    run = train_flagship.build('explorer', 16, 4, 32, 16, geometries=floorplans.sample(4),
                               device='cpu', res=160, subsample=4)
    run['carry'], _ = run.step(run.carry, run.generator)
    got = grad_noise.measure(run, 8, T=4, card='cpu')
    assert got['card_vs_cpu'] == got['card_reversed_vs_cpu_reversed'] == 0
    assert got['card_vs_f64'] == got['cpu_vs_f64']
    bound = 1e-5 * got['grad_scale']
    assert 0 < got['cpu_vs_f64'] < bound and got['cpu_vs_cpu_reversed'] < bound
