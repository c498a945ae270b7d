"""PPO + V-trace training driver.

Counterpart of :mod:`megastep_tpu.demo.train` (the reference
``megastep/demo/__init__.py:37-173``). One training chunk is

  * **rollout**: ``buffer_size`` env steps, each an agent forward at T=1, a
    sampled action and an ``env.step``, under ``torch.no_grad()``;
  * **learn**: PPO-clip/V-trace updates over random minibatches of env columns
    with the clipped AMSGrad optimizer, and the reference's KL early stop: once
    a minibatch's ``kl_div`` exceeds ``kl_limit``, the later minibatches do not
    run. The stop reads ``kl_div`` on the host, one sync per minibatch.

The JAX package jits both into one device program; here they run eagerly, and
the environment's own kernels (the observe kernel, on the card) run inside the
rollout. The agent (the parameters) and the optimizer (its moments) are part of
the carry, where the JAX carry holds ``params`` and ``opt_state``.

With a mesh (:mod:`megastep_tpu_torch.parallel.mesh`) the env is this rank's
slice, and the step trains the JAX package's sharded update
(``make_train_step(shard_mesh=...)``): shard-local minibatches, each a block of
every rank's own envs, and the advantage statistics, the gradients, the loss
terms (and with them the KL stop) and the rollout statistics taken over all
ranks. Without one, the path is the single-device one.
"""
import logging
import math
import time

import torch

from .. import tracing
from ..arrdict import arrdict, numpyify, stack
from ..dotdict import leaves
from ..models import Agent
from ..models.agent import f32_math
from ..ops.geom import div
from . import learning

log = logging.getLogger(__name__)

# optax.amsgrad's defaults (eps_root = 0).
B1, B2, EPS = .9, .999, 1e-8


def _expand_t(tree):
    return tree.map(lambda x: x[None])


def _squeeze_t(tree):
    return tree.map(lambda x: x[0])


@torch.no_grad()
def rollout(env, agent, env_state, world, agent_state, generator, T):
    """Rolls the env forward ``T`` steps under the current policy.

    :param generator: the ``torch.Generator``, on the env's device, that both the
        actions and the env's own draws come from.
    :return: ``(env_state, world, agent_state, chunk)`` — chunk has (T, B, ...)
        leaves of ``world`` and ``decision`` (the reference's buffer,
        ``demo/__init__.py:124-134``).
    """
    worlds, decisions = [], []
    for _ in range(T):
        with tracing.span('rollout.agent'):
            decision, agent_state = agent(_expand_t(world), agent_state, generator=generator,
                                          sample=True, value=True)
            decision = _squeeze_t(decision)
        worlds.append(world)
        decisions.append(decision)
        env_state, world = env.step(env_state, decision, generator)
    return env_state, world, agent_state, arrdict(world=stack(worlds), decision=stack(decisions))


def as_chunk(chunk, mesh=None):
    """Scalar rollout statistics, as 0-d tensors (reference ``as_chunk``,
    ``demo/__init__.py:37-52``); with a mesh, over every rank's chunk (one
    all-reduce)."""
    w = chunk.world
    n = w.reset.numel()
    trajs, reward = w.reset.sum().float(), w.reward.sum()
    if mesh is not None:
        n *= mesh.world
        trajs, reward = mesh.all_reduce(torch.stack([trajs, reward])).unbind()
    return dict(samples=torch.full((), n, dtype=torch.float32, device=trajs.device),
                trajs=trajs,
                step_reward=div(reward, n),
                traj_reward=reward / trajs.clamp(min=1))


def ppo_loss(agent, batch, state0, entropy=1e-2, gamma=.99, clip=.2, mesh=None):
    """PPO-clip policy loss + clipped V-trace value loss + entropy bonus
    (reference ``optimize``, ``demo/__init__.py:54-107``). Returns
    ``(loss, aux)``. With a mesh, the advantages are normalised by their mean
    and standard deviation over every rank's minibatch block
    (:meth:`~megastep_tpu_torch.parallel.mesh.Mesh.moments`), as the JAX
    package's sharded step normalises over the global minibatch; the loss and
    the other terms stay this rank's.

    ``torch.minimum``/``torch.maximum`` split a tie's gradient in half between
    their arguments, as JAX's do; on the first minibatch ``ratio`` is 1 and the
    policy loss's two sides tie wherever the clip lets it through.
    """
    w, d0 = batch.world, batch.decision
    d, _ = agent(w, state0, value=True)

    logits = learning.flatten(d.logits)
    old_logits = learning.flatten(learning.gather(d0.logits, d0.actions)).sum(-1)
    new_logits = learning.flatten(learning.gather(d.logits, d0.actions)).sum(-1)
    ratio = torch.exp(new_logits - old_logits).clamp(.05, 20)

    v_target = learning.v_trace(ratio, d.value, w.reward, w.reset, gamma=gamma)
    v_clipped = d0.value + (d.value - d0.value).clamp(-10, +10)
    v_loss = .5 * torch.maximum((d.value - v_target)**2, (v_clipped - v_target)**2).mean()

    adv = learning.generalized_advantages(d.value, w.reward, d.value, w.reset, gamma=gamma)
    if mesh is None:
        adv_mean, adv_std = adv.mean(), adv.std(correction=0)
    else:
        adv_mean, adv_std = mesh.moments(adv)
    normed_adv = (adv - adv_mean) / (1e-3 + adv_std)
    free_adv = ratio * normed_adv
    clip_adv = ratio.clamp(1 - clip, 1 + clip) * normed_adv
    p_loss = -torch.minimum(free_adv, clip_adv).mean()

    h_loss = (torch.exp(logits) * logits).sum(-1).mean()
    loss = v_loss + p_loss + entropy * h_loss

    kl_div = -(new_logits - old_logits).mean()
    aux = dict(v_loss=v_loss, p_loss=p_loss, h_loss=h_loss, kl_div=kl_div,
               v_target_mean=v_target.mean(), adv_std=adv_std)
    return loss, aux


class ClippedAMSGrad:
    """``optax.chain(clip_by_global_norm(max_grad_norm), amsgrad(lr))``, the JAX
    package's optimizer (``train.py:110-114``), over a list of parameters.

    Written out because PyTorch's forms differ: ``Adam(amsgrad=True)`` keeps the
    maximum of the raw second moment and divides by the step's bias correction,
    where optax keeps the maximum of the bias-corrected moment; and
    ``clip_grad_norm_`` adds 1e-6 to the norm, where optax keeps the gradient
    when its norm is under the limit and scales it by ``limit / norm``
    otherwise. A parameter with no gradient takes a zero one, as in JAX. The
    clip and the bias corrections stay on the device: no host sync.
    """

    def __init__(self, params, lr=3e-4, max_grad_norm=100.):
        self.params = list(params)
        self.lr, self.max_grad_norm = lr, max_grad_norm
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.nu_max = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def _bias_correction(self, decay):
        """``1 - decay**count`` in f32, as optax computes it, made on the
        parameters' device (so dividing by it is a true division, with no
        host-to-device copy)."""
        decay = torch.full((), decay, dtype=torch.float32, device=self.params[0].device)
        return 1 - decay**self.count

    @torch.no_grad()
    def step(self):
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        if self.max_grad_norm is not None:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            keep = norm < self.max_grad_norm
            grads = [torch.where(keep, g, g / norm * self.max_grad_norm) for g in grads]
        self.count += 1
        c1, c2 = self._bias_correction(B1), self._bias_correction(B2)
        for p, g, mu, nu, nu_max in zip(self.params, grads, self.mu, self.nu, self.nu_max):
            mu.copy_((1 - B1) * g + B1 * mu)
            nu.copy_((1 - B2) * g**2 + B2 * nu)
            torch.maximum(nu_max, nu / c2, out=nu_max)
            p.add_(mu / c1 / (torch.sqrt(nu_max) + EPS) * -self.lr)

    def state_dict(self):
        """The optimizer's state, optax's ``opt_state`` in the JAX carry: the
        step count and the three moment lists (tensors on the parameters'
        device)."""
        return {'count': self.count, 'mu': list(self.mu), 'nu': list(self.nu),
                'nu_max': list(self.nu_max)}

    @torch.no_grad()
    def load_state_dict(self, state):
        """Copies a :meth:`state_dict` into this optimizer's moments, in place."""
        for k in ('mu', 'nu', 'nu_max'):
            mine = getattr(self, k)
            if len(state[k]) != len(mine) or any(s.shape != m.shape
                                                 for s, m in zip(state[k], mine)):
                raise ValueError(f'{k}: the state does not fit these parameters')
            for m, s in zip(mine, state[k]):
                m.copy_(s)
        self.count = int(state['count'])


def optimizer(params, lr=3e-4, max_grad_norm=100.):
    """The demo optimizer: AMSGrad behind a global-norm-100 gradient clip
    (reference ``demo/__init__.py:78-81``); ``max_grad_norm=None`` is bare
    AMSGrad, ``optax.amsgrad(lr)``."""
    return ClippedAMSGrad(params, lr, max_grad_norm)


def optimize(agent, opt, batch, state0, mesh=None, **hp):
    """One gradient step on one minibatch. Returns the loss terms as detached
    0-d tensors. The forward and the backward both run in full f32
    (:func:`~megastep_tpu_torch.models.agent.f32_math`).

    With a mesh, the gradients are averaged over the ranks (one all-reduce of
    a flat buffer, then a division by the world) before the optimizer clips
    them by their global norm, and the loss terms are averaged over the ranks
    (one all-reduce). Every rank contributes an equal block, so these are the
    gradient and the terms of the global minibatch's loss."""
    with f32_math(agent.device):
        with tracing.span('learn.forward'):
            loss, aux = ppo_loss(agent, batch, state0, mesh=mesh, **hp)
        opt.zero_grad()
        with tracing.span('learn.backward'):
            loss.backward()
    if mesh is not None:
        _average_gradients(opt.params, mesh)
    with tracing.span('learn.optimizer'):
        opt.step()
    aux['loss'] = loss
    aux = {k: v.detach() for k, v in aux.items()}
    if mesh is not None:
        # adv_std is global already.
        keys = [k for k in aux if k != 'adv_std']
        aux.update(zip(keys, mesh.mean(torch.stack([aux[k] for k in keys])).unbind()))
    return aux


@torch.no_grad()
def _average_gradients(params, mesh):
    """Every parameter's gradient, averaged over the ranks as one flat buffer;
    a parameter with no gradient contributes a zero one."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    flat = mesh.mean(torch.cat([g.reshape(-1) for g in grads]))
    for p, g in zip(params, flat.split([g.numel() for g in grads])):
        p.grad = g.view_as(p)


class LossGraph:
    """A minibatch's loss and backward as one replay of a CUDA graph: the
    single-device learner's path on a card, where the eager loop's
    ~3,300 launches a minibatch cost the host more time than the card
    spends on them. The kernels are the eager path's.

    The graph reads static buffers of the minibatch's chunk leaves (dim 1)
    and start state (dim 0), which :meth:`__call__` fills with
    ``index_select``, and writes the parameters' ``.grad`` tensors, which it
    allocated at capture, and the loss terms. It is captured on the first
    call, after one eager forward and backward on a side stream (the
    gradients discarded, the optimizer untouched), and again only when the
    agent, a parameter's storage, the minibatch's shapes or dtypes, or the
    loss's hyperparameters differ from the capture's. Loading weights in
    place keeps it. Each train step owns its own, so the graph's memory pool
    lives as long as the step.
    """

    def __init__(self):
        self.key = self.graph = None

    def _capture(self, agent, chunk, state0, idx, hp):
        self.graph = self.inputs = self.out = self.grads = None  # frees the old pool
        width = len(idx)
        self.inputs = [x.new_empty((x.shape[0], width) + x.shape[2:]) for x in leaves(chunk)]
        self.inputs += [x.new_empty((width,) + x.shape[1:]) for x in leaves(state0)]
        self._fill(chunk, state0, idx)
        it = iter(self.inputs)
        batch = chunk.map(lambda x: next(it))
        s0 = state0.map(lambda x: next(it))
        params = list(agent.parameters())
        device = agent.device
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        for p in params:
            p.grad = None
        with torch.cuda.stream(stream), f32_math(device):
            with tracing.span('learn.forward'):
                loss, _ = ppo_loss(agent, batch, s0, **hp)
            with tracing.span('learn.backward'):
                loss.backward()
        torch.cuda.current_stream(device).wait_stream(stream)
        for p in params:
            p.grad = None  # so that the capture allocates them in the graph's pool
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream), f32_math(device):
            loss, aux = ppo_loss(agent, batch, s0, **hp)
            loss.backward()
        aux['loss'] = loss
        self.out = {k: v.detach() for k, v in aux.items()}
        self.grads = [p.grad for p in params]
        self.graph = graph
        tracing.count('learn_graph_captures')

    def _fill(self, chunk, state0, idx):
        it = iter(self.inputs)
        for x in leaves(chunk):
            torch.index_select(x, 1, idx, out=next(it))
        for x in leaves(state0):
            torch.index_select(x, 0, idx, out=next(it))

    def __call__(self, agent, chunk, state0, idx, **hp):
        """The gradients of one minibatch's loss (env columns ``idx``) in
        the parameters' ``.grad``; returns the loss terms as 0-d tensors of
        their own. The replay runs on the current stream."""
        key = (agent, [p.data_ptr() for p in agent.parameters()], len(idx),
               [(x.shape[:1] + x.shape[2:], x.dtype) for x in leaves(chunk)],
               [(x.shape[1:], x.dtype) for x in leaves(state0)], hp)
        if key != self.key:
            self.key = None
            self._capture(agent, chunk, state0, idx, hp)
            self.key = key
        for p, g in zip(agent.parameters(), self.grads):
            if p.grad is not g:
                p.grad = g
        self._fill(chunk, state0, idx)
        self.graph.replay()
        tracing.count('learn_graph_replays')
        return dict(zip(self.out, torch.stack(list(self.out.values())).unbind()))


def learn(agent, opt, chunk, state0, batches, kl_limit=.02, mesh=None, graph=None, **hp):
    """Minibatched PPO over a rollout chunk with the KL early stop
    (``train.py:202-245``). With a mesh, ``chunk`` and ``batches`` are this
    rank's, and the stop reads the global ``kl_div``, so every rank stops after
    the same minibatch.

    :param state0: the agent state at the chunk's start, batch-first.
    :param batches: (n_batches, batch_width) env indices, one row a minibatch.
    :param graph: a :class:`LossGraph`. With one, an agent on a card and no
        mesh, each minibatch's loss and backward are a replay of it, and the
        optimizer steps eagerly after; otherwise each minibatch is an eager
        :func:`optimize`.
    :return: the loss terms averaged over the minibatches that ran, and
        ``skipped``: the share of minibatches after whose update the stop had
        tripped, (n − k)/n when minibatch k tripped it; and ``minibatches``,
        the number that ran.
    """
    graphed = graph is not None and mesh is None and agent.device.type == 'cuda'
    rows, tripped = [], False
    for idx in batches:
        if graphed:
            with tracing.span('learn.graph'):
                aux = graph(agent, chunk, state0, idx, **hp)
            with tracing.span('learn.optimizer'):
                opt.step()
            rows.append(aux)
        else:
            batch = chunk.map(lambda x: x[:, idx])
            s0 = state0.map(lambda x: x[idx])
            rows.append(optimize(agent, opt, batch, s0, mesh=mesh, **hp))
        with tracing.span('learn.kl_read'):
            tracing.count('host_syncs')
            stop = bool(rows[-1]['kl_div'] > kl_limit)
        if stop:
            tripped = True
            break
    n = len(batches)
    metrics = {k: torch.stack([r[k] for r in rows]).mean() for k in rows[0]}
    metrics['skipped'] = torch.tensor((n - len(rows) + 1) / n if tripped else 0.)
    metrics['minibatches'] = torch.tensor(float(len(rows)))
    return metrics


def minibatches(perm, n_batches, width):
    """The learner's minibatches, one row of ``width`` env indices each: the
    first ``n_batches * width`` entries of the permutation ``perm``, in blocks.
    With a mesh, ``perm`` permutes a rank's own envs and ``width`` is its share
    of a minibatch: row ``b`` is this rank's block of the global minibatch
    ``b``, as in ``megastep_tpu/demo/train.py:170-187``."""
    return perm[:n_batches * width].reshape(n_batches, width)


def make_train_step(env, buffer_size=32, batch_size=16 * 1024, kl_limit=.02, mesh=None,
                    perm_generator=None, **hp):
    """Builds the one-chunk training step: rollout → minibatched PPO with the KL
    early stop (reference outer loop, ``demo/__init__.py:124-145``).

    :param mesh: a :class:`~megastep_tpu_torch.parallel.mesh.Mesh`; ``env`` is
        then this rank's slice, ``batch_size`` stays global, and each
        minibatch takes an equal block of every rank's envs (see
        :func:`minibatches`). The minibatch width must be a multiple of the
        world, as in the JAX package.
    :param perm_generator: with a mesh, the generator of the permutation of a
        rank's envs, the same on every rank (``None``: one seeded with 0 on the
        env's device); the rollout's generator is each rank's own.

    :return: ``step(carry, generator, mark=None) -> (carry, metrics)``, with
        carry the arrdict of :func:`init_carry` and metrics a dict of floats
        (one host sync at its end). ``generator`` draws the actions, the env's
        randomness and the learner's permutation. ``mark``, if given, is called
        before the rollout, between the rollout and the learner, and after the
        learner (e.g. to record CUDA events).
    """
    n_local = env.n_envs
    n_envs = n_local * (1 if mesh is None else mesh.world)
    batch_width = max(batch_size // buffer_size, 1)
    n_batches = n_envs // batch_width
    if n_batches < 1:
        raise ValueError(
            f'batch_size // buffer_size = {batch_width} env columns per '
            f'minibatch exceeds n_envs = {n_envs}: the learner would run '
            f'ZERO minibatches (and silently never train). Lower batch_size '
            f'or raise n_envs.')
    width = batch_width
    if mesh is not None:
        width = batch_width // mesh.world
        if width < 1 or batch_width % mesh.world:
            raise ValueError(
                f'minibatch width {batch_width} must be a multiple of the '
                f"mesh's {mesh.world} ranks so every rank contributes an "
                f'equal local block')
        if perm_generator is None:
            perm_generator = torch.Generator(env.device).manual_seed(0)
    graph = LossGraph() if mesh is None else None

    def step(carry, generator, mark=None):
        mark = mark or (lambda: None)
        with tracing.span('train.chunk'):
            agent, opt = carry.agent, carry.opt
            mark()
            with tracing.span('train.rollout'):
                env_state, world, agent_state, chunk = rollout(
                    env, agent, carry.env_state, carry.world, carry.agent_state, generator,
                    buffer_size)
            mark()
            with tracing.span('train.learn'):
                g = generator if mesh is None else perm_generator
                perm = torch.randperm(n_local, generator=g, device=g.device)
                metrics = learn(agent, opt, chunk, carry.agent_state,
                                minibatches(perm, n_batches, width), kl_limit, mesh=mesh,
                                graph=graph, **hp)
                metrics.update(as_chunk(chunk, mesh))
            mark()
            keys = list(metrics)
            with tracing.span('train.metrics_read'):
                tracing.count('host_syncs')
                values = torch.stack([metrics[k].to(agent.device) for k in keys]).tolist()
            new_carry = arrdict(agent=agent, opt=opt, env_state=env_state, world=world,
                                agent_state=agent_state)
        return new_carry, dict(zip(keys, values))

    return step


def init_carry(env, agent, opt, generator):
    """The carry (agent, opt, env_state, world, agent_state): the env reset from
    ``generator`` and a zeroed recurrent state on the agent's device."""
    env_state, world = env.reset(generator)
    return arrdict(agent=agent, opt=opt, env_state=env_state, world=world,
                   agent_state=agent.initial_state(env.n_envs))


def train(env=None, n_envs=8 * 1024, buffer_size=32, batch_size=16 * 1024, width=256,
          lr=3e-4, steps=None, run_name=None, seed=0, resume=None, profile=None,
          full_checkpoint=None, checkpoint_every=25, device='cuda', **hp):
    """The training entry point (reference ``train()``,
    ``demo/__init__.py:109-148``; the JAX package's ``demo/train.py:265-354``):
    Explorer + 256-wide LSTM agent + clipped AMSGrad, with stats, logs and
    throttled stored weights in the run directory (``rebar.paths.ROOT``/run).
    Runs for ``steps`` chunks, or until interrupted: Ctrl-C is deferred to the
    chunk's end, where the chunk's stats, weights and checkpoint are written,
    and then raises KeyboardInterrupt.

    :param env: an env; ``None`` builds ``Explorer(n_envs, device=device)``. A
        given env sets the device.
    :param run_name: the run directory's name; ``None`` means
        ``'%Y-%m-%d %H%M%S <EnvClass>'``. The directory is cleared first.
    :param seed: seeds the agent's initial parameters (drawn on the CPU, so
        the same on every device) and the run's generator. A resumed run
        draws from the seed's stream again, as JAX's key restarts there.
    :param resume: a run name (or negative index) whose newest stored weights
        to load into the agent before training.
    :param profile: the chunk index at which to trace one chunk with
        ``torch.profiler`` into the run's ``profile`` directory (a Chrome
        trace whose user annotations are the program's spans, such as
        ``train.learn`` and ``learn.backward``); None disables.
    :param full_checkpoint: a directory of full-carry checkpoints
        (:mod:`megastep_tpu_torch.parallel.checkpoint`). If it holds one,
        training resumes from it: parameters, optimizer state, env state,
        last world and recurrent state. Saved every ``checkpoint_every``
        chunks, numbered on from the restored step.
    :param hp: ``kl_limit`` and :func:`ppo_loss`'s ``entropy``/``gamma``/``clip``.
    :return: ``(carry, metrics)``, metrics a list of one dict per chunk.
    """
    from ..rebar import interrupting, paths, stats, storing, widgets
    from ..rebar import logging as rlogging

    if env is None:
        from ..envs import Explorer
        env = Explorer(n_envs, device=device)
    device = env.device
    agent = Agent(env.obs_space, env.action_space, width=width,
                  generator=torch.Generator().manual_seed(seed)).to(device)
    opt = optimizer(agent.parameters(), lr)
    generator = torch.Generator(device).manual_seed(seed)
    carry = init_carry(env, agent, opt, generator)
    if resume is not None:
        agent.load_state_dict(storing.load(resume)['agent'])
        log.info('resumed params from run %r', resume)
    ckpt_base = 0
    if full_checkpoint is not None:
        from ..parallel import checkpoint
        restored = checkpoint.restore(full_checkpoint, carry)
        if restored is not None:
            carry = restored
            # Continue the step numbering past the restored checkpoint.
            ckpt_base = checkpoint.latest_step(full_checkpoint)
            log.info('resumed full carry from %s (step %s)', full_checkpoint, ckpt_base)
    step = make_train_step(env, buffer_size, batch_size, **hp)

    run_name = run_name or f'{time.strftime("%Y-%m-%d %H%M%S")} {type(env).__name__}'
    paths.clear(run_name)
    compositor = widgets.Compositor()
    history = []
    with rlogging.via_dir(run_name, compositor), stats.via_dir(run_name, compositor), \
            interrupting.interrupter() as interrupt:
        i = 0
        while steps is None or i < steps:
            t0 = time.time()
            if i == profile:
                carry, metrics = _profiled(step, carry, generator, run_name)
            else:
                carry, metrics = step(carry, generator)
            history.append(dict(metrics))
            step_s = time.time() - t0
            t1 = time.time()
            storing.store_latest(run_name, dict(agent=carry.agent), throttle=60)
            if full_checkpoint is not None and (i + 1) % checkpoint_every == 0:
                checkpoint.save(full_checkpoint, ckpt_base + i + 1, carry)
            # The JAX step has no minibatch count; its run writes no such channel.
            metrics.pop('minibatches')
            with stats.defer():
                stats.rate('sample-rate/actor', int(metrics.pop('samples')))
                stats.mean('traj-reward/mean', metrics.pop('traj_reward'))
                stats.mean('step-reward', metrics.pop('step_reward'))
                stats.cumsum('count/traj', metrics.pop('trajs'))
                for k, v in metrics.items():
                    stats.mean(f'opt/{k}', v)
                stats.duty('duty/step', step_s)
                stats.duty('duty/store', time.time() - t1)
                stats.device.vitals(throttle=10)
            log.info('step %d done', i)
            i += 1
            interrupt.check()
    return carry, history


def _profiled(step, carry, generator, run_name):
    """One chunk under ``torch.profiler`` (CPU activity, and CUDA's on the
    card), the device synced before the trace closes; the Chrome trace goes
    to the run's ``profile`` directory. The program's spans
    (:mod:`megastep_tpu_torch.tracing`) are on for the chunk, so the trace
    carries the layer names (``train.rollout``, ``rollout.agent``,
    ``env.step``, ``learn.backward``, ...) as user annotations around the
    operations each launched. Spans recorded only for this chunk are dropped
    after it."""
    from ..rebar import paths
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = generator.device.type == 'cuda'
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    was_on = tracing.enabled()
    tracing.enable()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            carry, metrics = step(carry, generator)
            if cuda:
                torch.cuda.synchronize()
    finally:
        if not was_on:
            tracing.disable()
            tracing.drain()
    trace = paths.path(run_name, 'profile').with_suffix('.json')
    prof.export_chrome_trace(str(trace))
    log.info('profile trace of a chunk in %s', trace)
    return carry, metrics


def is_finite(metrics):
    """Whether every metric of a chunk is a finite number."""
    return all(math.isfinite(v) for v in metrics.values())


@torch.no_grad()
def demo(run=-1, length=None, test=True, N=None, env=None, agent=None, params=None,
         d=0, seed=0, backend='process', device='cuda'):
    """Rolls out a trained agent and encodes a video of env ``d`` (reference
    ``demo()``, ``demo/__init__.py:150-173``; the JAX package's
    ``demo/train.py:357-391``). Returns the
    :class:`~megastep_tpu_torch.rebar.recording.ParallelEncoder`, whose
    ``result()`` is the video's bytes.

    Each step's snapshot (``env.state(..., d)`` with the agent's value of env
    ``d`` as ``decision.value``) is copied to the host and plotted by
    ``env.plot_state`` in the encoder's worker pool; the rollout stays on the
    env's device.

    :param run: the run whose newest stored weights to load when ``params`` is
        None.
    :param length: frames to record; None records until an env resets.
    :param test: act greedily (the argmax) instead of sampling.
    :param N: the encoder's worker count (see ``ParallelEncoder``).
    :param env: an env; ``None`` builds ``Explorer(d + 1, device=device)``. A
        given env sets the device.
    :param agent: the agent module; ``None`` builds
        ``Agent(env.obs_space, env.action_space)`` (width 256).
    :param params: a ``state_dict`` loaded strictly into the agent; ``None``
        means ``storing.load(run)['agent']``.
    :param seed: seeds the ``torch.Generator``, on the env's device, that the
        env's draws and any sampled actions come from.
    :param backend: the encoder pool's backend: 'process', 'thread' or 'serial'.
    """
    from ..envs import Explorer
    from ..rebar import recording, storing

    env = Explorer(d + 1, device=device) if env is None else env
    agent = Agent(env.obs_space, env.action_space) if agent is None else agent
    if params is None:
        params = storing.load(run)['agent']
    agent.load_state_dict(params)
    agent.to(env.device)

    generator = torch.Generator(env.device).manual_seed(seed)
    env_state, world = env.reset(generator)
    agent_state = agent.initial_state(env.n_envs)

    steps = 0
    with recording.ParallelEncoder(env.plot_state, N=N, backend=backend) as encoder:
        while True:
            decision, agent_state = agent(_expand_t(world), agent_state, generator=generator,
                                          sample=True, test=test, value=True)
            decision = _squeeze_t(decision)
            env_state, world = env.step(env_state, decision, generator)
            steps += 1
            if length is None and bool(world.reset.any()):
                break
            state = env.state(env_state, world, d)
            state['decision'] = arrdict(value=numpyify(decision.value[d]).reshape(-1))
            encoder(state)
            if steps == length:
                break
    return encoder
