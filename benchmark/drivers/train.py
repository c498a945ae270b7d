"""The training traffic: the flagship train step in a closed loop, one chunk
after another: a rollout of ``buffer`` steps of every env, the agent sampling
each action, then PPO over minibatches of ``batch`` samples until the KL stop.

Set-up builds the env, the agent, the optimizer and the step through the
program's public entry points (``envs.Explorer``, ``models.Agent``,
``demo.train.optimizer``, ``init_carry``, ``make_train_step``), hands the step
a thin proxy of the env, and drives the step from the seed through its first
``checked_chunks`` chunks: the warm-up, and the chunks the check follows. The
window then runs whole chunks of the same object for ``seconds``. The proxy
draws the spawn slots of respawning agents from its own generator (the env
takes them as given draws), records the actions of the checked chunks and, in
a traced run, CUDA events around each ``env.step``.

The check: the plain reference builds the world, the agent and the optimizer
again from the plans and the seed, replays the checked chunks with the same
draws (the same generator's uniforms for the actions and permutations for the
minibatches, in the program's order, and the proxy's spawn slots), and is
compared with the program's initial parameters, actions, losses, KL-stop
counts, first gradient and parameter change.
"""
import importlib

import numpy as np
import torch

from benchmark import common
from benchmark.inputs import floorplans
from benchmark.reference import agent as ref_agent
from benchmark.reference import learner as ref_learner
from benchmark.reference import world as ref
from benchmark.drivers.step import _blocks, _cat

B1 = .9
#: The env step at which the planted fault 'alter' alters one env's reward.
ALTER_STEP = 2


def _inputs(c, seed):
    cfg, traffic = c['config'], c['traffic']
    s_plans, s_scene, s_agent, s_gen, s_env = common.seeds(seed, 5)
    plans = floorplans.arranged(cfg['plans'], cfg['plan_seed'], traffic['n_envs'], s_plans)
    return plans, dict(scene=s_scene, agent=s_agent, gen=s_gen, env=s_env)


class EnvProxy:
    """The program's env as the train step sees it, with the spawn draws made
    here, the checked chunks' actions kept and, when ``events`` is a list,
    a pair of CUDA events around every step."""

    def __init__(self, env, gen, fault=None):
        self.env, self.gen, self.fault = env, gen, fault
        self.actions, self.rewards, self.events, self.steps = None, None, None, 0
        self.obs_space, self.action_space = env.obs_space, env.action_space

    @property
    def n_envs(self):
        return self.env.n_envs

    @property
    def device(self):
        return self.env.device

    def _choices(self):
        return torch.randint(0, 100, (self.env.n_envs, 1), generator=self.gen,
                             device=self.gen.device)

    def reset(self, rng):
        return self.env.reset(self._choices())

    def step(self, state, decision, rng):
        choices = self._choices()
        if self.actions is not None:
            self.actions.append(decision.actions)
        if self.events is not None:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        state, world = self.env.step(state, decision, choices)
        if self.events is not None:
            end.record()
            self.events.append((start, end))
        self.steps += 1
        if self.fault == 'alter' and self.steps == ALTER_STEP:
            # A planted fault, for the benchmark's own test: one env's reward
            # altered where it is produced.
            world['reward'] = world.reward.clone()
            world.reward[0] += 1.
        if self.rewards is not None:
            self.rewards.append(world.reward)
        return state, world


def _half_loss(loss_fn):
    """A planted fault, for the benchmark's own test: each minibatch's loss
    over the first half of its envs only."""
    def half(agent, batch, state0, **kw):
        w = batch.world.reset.shape[1] // 2
        return loss_fn(agent, batch.map(lambda x: x[:, :w]), state0.map(lambda x: x[:w]),
                       **kw)
    return half


def build(c, seed, device, fault=None):
    """The program's train step and carry, on a proxy of its env."""
    from megastep_tpu_torch import envs
    from megastep_tpu_torch.models import Agent
    train = importlib.import_module('megastep_tpu_torch.demo.train')
    cfg, traffic = c['config'], c['traffic']
    plans, s = _inputs(c, seed)
    env = envs.Explorer(traffic['n_envs'], geometries=plans, subsample=cfg['subsample'],
                        res=cfg['res'], fov=cfg['fov'],
                        random=np.random.RandomState(s['scene']), device=device)
    proxy = EnvProxy(env, torch.Generator(device).manual_seed(s['env']), fault)
    agent = Agent(env.obs_space, env.action_space, width=cfg['width'], core=cfg['core'],
                  generator=torch.Generator().manual_seed(s['agent'])).to(device)
    opt = train.optimizer(agent.parameters(), cfg['lr'], cfg['max_grad_norm'])
    gen = torch.Generator(device).manual_seed(s['gen'])
    carry = train.init_carry(proxy, agent, opt, gen)
    step = train.make_train_step(proxy, buffer_size=traffic['buffer'],
                                 batch_size=traffic['batch'], kl_limit=cfg['kl_limit'])
    if fault == 'half':
        train.ppo_loss = _half_loss(train.ppo_loss)
    if fault == 'unchanged':
        inner = step

        def step(carry, generator, mark=None):
            saved = [p.detach().clone() for p in carry.agent.parameters()]
            carry, metrics = inner(carry, generator, mark)
            with torch.no_grad():
                for p, q in zip(carry.agent.parameters(), saved):
                    p.copy_(q)
            return carry, metrics
    return proxy, agent, opt, gen, carry, step


def _norms(tensors):
    return [float(t.float().norm()) for t in tensors]


def run(c, seed, seconds, trace, device, t_start, fault=None):
    train = importlib.import_module('megastep_tpu_torch.demo.train')
    loss_fn = train.ppo_loss
    try:
        return _run(c, seed, seconds, trace, device, t_start, fault)
    finally:
        train.ppo_loss = loss_fn


def _run(c, seed, seconds, trace, device, t_start, fault):
    traffic = c['traffic']
    proxy, agent, opt, gen, carry, step = build(c, seed, device, fault)
    sync = torch.cuda.synchronize if device == 'cuda' else (lambda: None)

    # The checked chunks: the same step object, driven from the seed.
    init = [p.detach().clone() for p in agent.parameters()]
    first = {}
    opt_step = opt.step

    def first_step():
        opt_step()
        first['grads'] = _norms(m / (1 - B1) for m in opt.state_dict()['mu'])
        del opt.step  # back to the class's own
    opt.step = first_step
    proxy.actions, proxy.rewards = [], []
    losses, minibatches, deltas = [], [], []
    for _ in range(traffic['checked_chunks']):
        carry, metrics = step(carry, gen)
        losses.append(metrics['loss'])
        minibatches.append(metrics['minibatches'])
        deltas.append(_norms(p.detach() - q for p, q in zip(agent.parameters(), init)))
    prog = dict(init=[p.cpu() for p in init], actions=proxy.actions, rewards=proxy.rewards,
                losses=losses, minibatches=minibatches, grads=first['grads'], deltas=deltas,
                names=[n for n, _ in agent.named_parameters()])
    proxy.actions = proxy.rewards = None
    del init
    sync()
    setup_s = common.now() - t_start

    marks = []

    def mark():
        if device == 'cuda':
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append(e)
    if trace and device == 'cuda':
        proxy.events = []
    minibatches = []
    t0 = common.now()
    while True:
        carry, metrics = step(carry, gen, mark)
        minibatches.append(metrics['minibatches'])
        if common.now() - t0 >= seconds:
            break
    window_s = common.now() - t0
    n = len(minibatches)
    samples = proxy.n_envs * traffic['buffer']
    print(f'window: {n} chunks in {window_s:.3f} s', flush=True)
    records = dict(window_s=window_s, chunks=n, samples_per_chunk=samples,
                   batch=traffic['batch'],
                   minibatches=minibatches,
                   obs_shapes={k: tuple(v.shape) for k, v in proxy.obs_space.items()},
                   width=c['config']['width'], n_actions=proxy.action_space.shape[-1])
    if marks:
        records['rollout_ms'] = [marks[3 * i].elapsed_time(marks[3 * i + 1]) for i in range(n)]
        records['learner_ms'] = [marks[3 * i + 1].elapsed_time(marks[3 * i + 2])
                                 for i in range(n)]
    if proxy.events:
        per = [s.elapsed_time(e) for s, e in proxy.events]
        b = traffic['buffer']
        records['env_step_ms'] = [sum(per[i * b:(i + 1) * b]) for i in range(n)]
    out = dict(attempted=n, failed=0,
               metrics=common.train_metrics(samples, n, window_s, setup_s),
               records=records)
    if trace:
        proxy.events = None
        # Device activity alone first (the idle share, the kernels' times),
        # then with the host's (what the host did in each idle gap).
        for key, host in (('trace', False), ('host_trace', True)):
            _, records[key] = common.traced(lambda: step(carry, gen), host)
            t0, t1 = records[key]['span']
            records[f'{key}_chunk_ms'] = 1e-3 * (t1 - t0)
    out['memory_peak_bytes'] = torch.cuda.max_memory_allocated() if device == 'cuda' else 0

    del carry, step, proxy, agent, opt
    if device == 'cuda':
        torch.cuda.empty_cache()
    out['checks'] = numbers(prog, reference(c, seed, device))
    return out


def reference(c, seed, device, tf32=False, half=False, alter=False):
    """The plain reference's replay of the checked chunks: the same summary
    as the program's. ``tf32`` is the lower-precision control; ``half`` and
    ``alter`` are planted faults (the loss over half of each minibatch; one
    env's reward altered at step ``ALTER_STEP``)."""
    cfg, traffic = c['config'], c['traffic']
    plans, s = _inputs(c, seed)
    order = ref.scene_order(plans, 1)
    world = ref.build([plans[i] for i in order], 1, np.random.RandomState(s['scene']),
                      device, cfg['res'], cfg['fov'], cfg['subsample'])
    N = traffic['n_envs']
    R = cfg['res'] // cfg['subsample']
    shapes = dict(rgb=(1, 3, 1, R), d=(1, 1, 1, R), imu=(1, 3))
    agent = ref_agent.Agent(shapes, 1, 7, cfg['width'],
                            torch.Generator().manual_seed(s['agent'])).to(device)
    init = [p.detach().clone() for p in agent.parameters()]
    opt = ref_learner.AMSGrad(agent.parameters(), cfg['lr'], cfg['max_grad_norm'])
    env_gen = torch.Generator(device).manual_seed(s['env'])
    gen = torch.Generator(device).manual_seed(s['gen'])
    blocks = _blocks(world)
    steps, rewards = [0], []

    def choices():
        return torch.randint(0, 100, (N, 1), generator=env_gen, device=device)

    def env_step(state, actions):
        ch = choices()
        outs = [ref.explorer_step(ref.slice_envs(world, n0, n1),
                                  {k: (v[n0:n1] if torch.is_tensor(v) else
                                       {a: b[n0:n1] for a, b in v.items()})
                                   for k, v in state.items()},
                                  actions[n0:n1], ch[n0:n1])[:2] for n0, n1 in blocks]
        state, w = _cat([o[0] for o in outs]), _cat([o[1] for o in outs])
        steps[0] += 1
        if alter and steps[0] == ALTER_STEP:
            w['reward'][0] += 1.
        rewards.append(w['reward'])
        return state, w

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        ch = choices()
        resets = [ref.explorer_reset(ref.slice_envs(world, n0, n1), ch[n0:n1])
                  for n0, n1 in blocks]
        env_state, w = _cat([r[0] for r in resets]), _cat([r[1] for r in resets])
        obs, reset, reward = w['obs'], w['reset'], w['reward']
        agent_state = agent.initial_state(N, device)
        width = traffic['batch'] // traffic['buffer']
        n_batches = N // width
        actions, losses, minibatches, first, deltas = [], [], [], [], []

        def on_update(grads):
            if not first:
                first.extend(_norms(grads))
        for _ in range(traffic['checked_chunks']):
            state0 = agent_state
            chunk, (obs, reset, reward, env_state, agent_state) = ref_learner.rollout(
                agent, env_step, obs, reset, reward, env_state, agent_state,
                lambda shape: torch.rand(shape, generator=gen, device=device),
                traffic['buffer'])
            actions.extend(chunk['actions'].unbind(0))
            perm = torch.randperm(N, generator=gen, device=device)
            batches = perm[:n_batches * width].reshape(n_batches, width)
            ls = ref_learner.learn(agent, opt, chunk, state0, batches, cfg['kl_limit'],
                                   half=half, on_update=on_update)
            losses.append(float(np.mean(ls)))
            minibatches.append(float(len(ls)))
            deltas.append(_norms(p.detach() - q for p, q in zip(agent.parameters(), init)))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return dict(init=[p.cpu() for p in init], actions=actions, rewards=rewards,
                losses=losses, minibatches=minibatches, grads=first, deltas=deltas)


def numbers(prog, refr):
    """The numbers compared for ``correct``, each beside its name:

    * ``rollout_mismatch``: the first chunk's actions and rewards that differ
      (both sides start that chunk from equal parameters and draws);
    * ``loss_gap``: the gap of the first chunk's mean loss, over the
      reference's;
    * ``grad_gap``: per parameter, the gap between the norms of the first
      clipped gradient, over the reference's norm or the median parameter's,
      whichever is larger; the worst parameter;
    * ``update_gap``: the same of the parameters' change over the first
      chunk, leaving out parameters whose reference gradient is under a
      thousandth of the median's.

    Printed beside them and not compared: the largest gap between the two
    sides' initial parameters (0 on every seed, the control's and the faults'
    too), and the later chunks' losses, actions, KL-stop counts and change:
    the card's convolution weight gradients sum with atomics, so from the
    second chunk on the two sides' parameters, and then their trajectories,
    part by rounding, and a KL near its limit can stop one side's learner
    and not the other's.
    """
    init = max(float((p - r).abs().max()) if p.shape == r.shape else float('inf')
               for p, r in zip(prog['init'], refr['init']))
    T = len(prog['actions']) // len(prog['losses'])
    if len(prog['actions']) != len(refr['actions']):
        per_chunk = [float('inf')]
    else:
        per_chunk = [sum(common.mismatches(p.reshape(-1), r.reshape(-1))
                         for p, r in zip(prog['actions'][i:i + T], refr['actions'][i:i + T]))
                     for i in range(0, len(prog['actions']), T)]
    rewards = sum(common.mismatches(p, r) for p, r in zip(prog['rewards'][:T],
                                                            refr['rewards'][:T]))
    losses = [abs(p - r) / abs(r) for p, r in zip(prog['losses'], refr['losses'])]
    g_p, g_r = np.array(prog['grads']), np.array(refr['grads'])
    g_med = np.median(g_r)
    grads = np.abs(g_p - g_r) / np.maximum(g_r, g_med)
    counted = g_r >= 1e-3 * g_med

    def change_gap(i):
        d_p, d_r = np.array(prog['deltas'][i]), np.array(refr['deltas'][i])
        return np.where(counted, np.abs(d_p - d_r) / np.maximum(d_r, np.median(d_r[counted])),
                        0.), d_r
    updates, d_r = change_gap(0)
    names = prog.get('names', [str(i) for i in range(len(g_r))])
    worst = lambda gaps, norms: [(names[i], float(gaps[i]), float(norms[i]))
                                 for i in np.argsort(-gaps)[:3]]
    print(f'check detail: initial parameters\' gap {init}; loss gaps a chunk {losses} ({prog["losses"]} against '
          f'{refr["losses"]}); actions off a chunk {per_chunk}; rewards off in the first '
          f'{rewards}; minibatches {prog["minibatches"]} against {refr["minibatches"]}; '
          f'worst grads {worst(grads, g_r)}; worst changes after the first chunk '
          f'{worst(updates, d_r)}; after each chunk, the worst change gap '
          f'{[float(change_gap(i)[0].max()) for i in range(len(prog["deltas"]))]}; '
          f'left out {[names[i] for i in np.flatnonzero(~counted)]}', flush=True)
    return [('rollout_mismatch', per_chunk[0] + rewards),
            ('loss_gap', losses[0]), ('grad_gap', float(grads.max())),
            ('update_gap', float(updates.max()))]
