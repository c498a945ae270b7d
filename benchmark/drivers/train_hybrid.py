"""The hybrid training traffic: the flagship train step in a closed loop, one
chunk after another, with the agent's policy and value cores the
Granite-4.0-H hybrid core (``core='granite_hybrid'``) at the configuration's
widths: a rollout of ``buffer`` steps of every env, the agent sampling each
action, then PPO over minibatches of ``batch`` samples until the KL stop.

Set-up builds the env, the agent, the optimizer and the step through the
program's public entry points (``envs.Explorer``, ``models.Agent`` with
``core_config``, ``demo.train.optimizer``, ``init_carry``,
``make_train_step``) on the flagship driver's env proxy, runs one checked
chunk and one more, and the window runs whole chunks for
``seconds``. ``setup_s`` leaves out the seconds of the check's reference
(``records['check_s']``). With ``--trace 1`` three more chunks follow: the device alone,
the host and the device, and one with the program's spans on
(``benchmark/spans.py``'s pass B), whose table and counters the per-layer
metrics read. After the window one more chunk is checked: the first of at
most ``later_chunks`` in which some env resets at t > 0.

The check is teacher-forced: random weights make sampled actions flip on
rounding. For a checked chunk the plain reference (``reference/hybrid.py``)
is given the program's parameters, the chunk's start state, observations,
resets and actions, and computes, in blocks of envs so that it fits beside the
program: the per-step logits and values through its loop, against the
rollout's; the chunk-end state (SSM, conv, the live keys and values of the
memory); and for the first minibatch, the loss, each parameter's clipped
gradient and its AMSGrad update from the program's moments, against the
program's (the update as the program's optimizer made it). Its gradient is
taken in two passes: the loss's gradient in the logits and values of the whole
minibatch, then each block's backward from those.

Readings that set the limits (the benchmark's runs do not run this)::

    python3 -m benchmark.drivers.train_hybrid --mode control --seeds 1,2,3

``sound`` runs the program as a run has it; ``control`` puts the reference
computed with TF32 in the program's place; ``reset`` plants a fault in the
program, a scan that drops its resets (the conv and the attention still cut).
"""
import argparse
import contextlib
import importlib
import json
import math
import sys
import time

import numpy as np
import torch

from benchmark import common, spans
from benchmark.drivers import train as flagship
from benchmark.reference import hybrid as ref
from benchmark.reference import learner as ref_learner

#: The configuration's keys that size the core (``HybridCore``'s arguments).
CORE_KEYS = ('layer_types', 'mamba_expand', 'mamba_n_heads', 'mamba_d_head', 'mamba_d_state',
             'mamba_n_groups', 'mamba_d_conv', 'mamba_conv_bias', 'mamba_proj_bias',
             'num_attention_heads', 'num_key_value_heads', 'attention_multiplier',
             'attention_bias', 'shared_intermediate_size', 'rms_norm_eps',
             'residual_multiplier', 'embedding_multiplier', 'mem_len')
#: The spans whose device time a traced run keeps.
SPANS = ('train.chunk', 'train.rollout', 'rollout.agent', 'core.mamba', 'core.attention',
         'env.step', 'train.learn', 'learn.graph', 'learn.optimizer', 'learn.kl_read')
#: The numbers of each checked chunk.
KEYS = ('logits_gap', 'value_gap', 'state_gap', 'memory_mismatch', 'loss_gap', 'grad_gap',
        'update_gap')
#: The checked chunks: set-up's first (its numbers named as the flagship
#: train cell's, which checks that chunk) and the later one.
TAGS = ('', '.later')
#: Chunks run after the checked one in set-up, before the window.
WARM_CHUNKS = 1
#: Envs a block of the reference's teacher-forced rollout, and of its
#: gradient's backward (each env keeps ~1.2 GB of the loop's activations).
CHECK_BLOCK, GRAD_BLOCK = 32, 2
B1, B2, EPS = ref_learner.B1, ref_learner.B2, ref_learner.EPS


def _train():
    return importlib.import_module('megastep_tpu_torch.demo.train')


def core_config(cfg):
    return {k: cfg[k] for k in CORE_KEYS}


def build(c, seed, device):
    """The program's train step and carry, on the flagship driver's env proxy."""
    from megastep_tpu_torch import envs
    from megastep_tpu_torch.models import Agent
    train = _train()
    cfg, traffic = c['config'], c['traffic']
    plans, s = flagship._inputs(c, seed)
    env = envs.Explorer(traffic['n_envs'], geometries=plans, subsample=cfg['subsample'],
                        res=cfg['res'], fov=cfg['fov'],
                        random=np.random.RandomState(s['scene']), device=device)
    proxy = flagship.EnvProxy(env, torch.Generator(device).manual_seed(s['env']))
    agent = Agent(env.obs_space, env.action_space, width=cfg['hidden_size'], core=cfg['core'],
                  generator=torch.Generator().manual_seed(s['agent']),
                  core_config=core_config(cfg)).to(device)
    opt = train.optimizer(agent.parameters(), cfg['lr'], cfg['max_grad_norm'])
    gen = torch.Generator(device).manual_seed(s['gen'])
    carry = train.init_carry(proxy, agent, opt, gen)
    step = train.make_train_step(proxy, buffer_size=traffic['buffer'],
                                 batch_size=traffic['batch'], kl_limit=cfg['kl_limit'])
    return proxy, agent, opt, gen, carry, step


@contextlib.contextmanager
def dropped_resets():
    """The planted fault: the program's scan, in both its forms, ignores the
    resets."""
    hybrid = importlib.import_module('megastep_tpu_torch.models.hybrid')
    saved = hybrid.ssm_step, hybrid.ssm_chunk

    def drop(fn):
        def scan(ssm, x, dt, A, B, C, reset):
            return fn(ssm, x, dt, A, B, C, torch.zeros_like(reset))
        return scan
    hybrid.ssm_step, hybrid.ssm_chunk = drop(saved[0]), drop(saved[1])
    try:
        yield
    finally:
        hybrid.ssm_step, hybrid.ssm_chunk = saved


@contextlib.contextmanager
def precision(tf32):
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = m.allow_tf32, c.allow_tf32
    m.allow_tf32 = c.allow_tf32 = tf32
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = saved


def _clock():
    """The host's clock once the device has done what was asked of it, so
    that the check's seconds hold neither the program's work before it nor
    its own left running after it."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.perf_counter()


def _blocks(n, size):
    return [slice(i, min(i + size, n)) for i in range(0, n, size)]


class _Recorder:
    """The learner's graph, its first minibatch's loss kept."""

    def __init__(self, graph, rec):
        self.graph, self.rec = graph, rec

    def __call__(self, *args, **kwargs):
        aux = self.graph(*args, **kwargs)
        self.rec.setdefault('loss', aux['loss'])
        return aux


class Check:
    """The check of one chunk, armed around one call of the train step: the
    train module's ``rollout`` and ``learn`` are wrapped so that the reference
    reads the chunk, its start state and the first minibatch where the step
    makes them.

    :param control: the reference with TF32 judged in the program's place.
    :param inner: check only a chunk with a reset at t > 0; otherwise leave it.
    """

    def __init__(self, c, proxy, agent, opt, control=False, inner=False):
        self.cfg = c['config']
        self.agent, self.opt, self.control, self.inner = agent, opt, control, inner
        self.numbers, self.armed, self.rec = None, False, {}
        self.train = _train()
        self.ref = ref.Agent({k: tuple(v.shape) for k, v in proxy.obs_space.items()},
                             *proxy.action_space.shape, self.cfg)

    def __enter__(self):
        self.saved = self.train.rollout, self.train.learn
        self.train.rollout, self.train.learn = self._rollout, self._learn
        return self

    def __exit__(self, *exc):
        self.train.rollout, self.train.learn = self.saved
        return False

    # --- the rollout ------------------------------------------------------------

    def _rollout(self, env, agent, env_state, world, agent_state, generator, T):
        out = self.saved[0](env, agent, env_state, world, agent_state, generator, T)
        chunk = out[3]
        inner = int(chunk.world.reset[1:].sum())
        if self.inner and not inner:
            return out
        self.armed = True
        t = _clock()
        self.numbers = dict(inner_resets=inner, **self._rollout_numbers(chunk, agent_state, out[2]))
        self.numbers['rollout_check_s'] = _clock() - t
        return out

    @torch.no_grad()
    def _rollout_numbers(self, chunk, state0, end):
        params = {n: p.detach() for n, p in self.agent.named_parameters()}
        obs, reset = chunk.world.obs, chunk.world.reset
        mismatch, sums = 0, {}
        for blk in _blocks(reset.shape[1], CHECK_BLOCK):
            with precision(False):
                logits, value, new = self.ref(params, obs[:, blk], reset[:, blk], state0[blk])
            if self.control:
                with precision(True):
                    lj, vj, nj = self.ref(params, obs[:, blk], reset[:, blk], state0[blk])
            else:
                lj, vj = chunk.decision.logits[:, blk], chunk.decision.value[:, blk]
                nj = {side: ref.from_program_state(self.cfg, end[side][blk]) for side in new}
            for key, judged, want in (('logits', lj, logits), ('value', vj, value)):
                acc = sums.setdefault(key, [0., 0.])
                acc[0] += float(((judged - want) ** 2).sum())
                acc[1] += float((want * want).sum())
            for side in new:
                for layer, s in new[side].items():
                    live = s.get('live')
                    if live is not None:
                        mismatch += int((nj[side][layer]['live'] != live).sum())
                    for k, v in s.items():
                        if k == 'live':
                            continue
                        d = nj[side][layer][k] - v
                        if live is not None:
                            d, v = d[live], v[live]
                        acc = sums.setdefault((side, layer, k), [0., 0.])
                        acc[0] += float((d * d).sum())
                        acc[1] += float((v * v).sum())
            del logits, value, new, lj, vj, nj
        gap = {k: math.sqrt(a) / max(math.sqrt(b), 1e-30) for k, (a, b) in sums.items()}
        return dict(logits_gap=gap.pop('logits'), value_gap=gap.pop('value'),
                    state_gap=max(gap.values()), memory_mismatch=mismatch)

    # --- the first minibatch ----------------------------------------------------

    def _learn(self, agent, opt, chunk, state0, batches, *args, **kwargs):
        if not self.armed:
            return self.saved[1](agent, opt, chunk, state0, batches, *args, **kwargs)
        rec = self.rec
        if kwargs.get('graph') is not None:
            kwargs['graph'] = _Recorder(kwargs['graph'], rec)
        optimize = self.train.optimize

        def recorded(*a, **k):
            aux = optimize(*a, **k)
            rec.setdefault('loss', aux['loss'])
            return aux
        opt.step = lambda: self._first_step(chunk, state0, batches[0])
        self.train.optimize = recorded
        try:
            metrics = self.saved[1](agent, opt, chunk, state0, batches, *args, **kwargs)
        finally:
            self.train.optimize = optimize
            opt.__dict__.pop('step', None)
        loss = rec.get('judged_loss', rec['loss'])
        self.numbers['loss_gap'] = abs(float(loss) - rec['ref_loss']) / abs(rec['ref_loss'])
        self.armed = False
        return metrics

    def _ref_grads(self, batch, s0, tf32):
        """The reference's loss on the minibatch and each parameter's gradient,
        the backward in blocks of envs."""
        leaves = {n: p.detach().requires_grad_() for n, p in self.agent.named_parameters()}
        obs, reset = batch.world.obs, batch.world.reset
        blocks = _blocks(reset.shape[1], GRAD_BLOCK)
        with precision(tf32):
            with torch.no_grad():
                outs = [self.ref(leaves, obs[:, b], reset[:, b], s0[b])[:2] for b in blocks]
            logits = torch.cat([o[0] for o in outs], 1).requires_grad_()
            value = torch.cat([o[1] for o in outs], 1).requires_grad_()
            d = batch.decision
            mb = dict(obs=None, reset=reset, reward=batch.world.reward, logits=d.logits,
                      value=d.value, actions=d.actions)
            loss, _ = ref_learner.ppo_loss(lambda *a: (logits, value, None, None), mb, None)
            g_logits, g_value = torch.autograd.grad(loss, [logits, value])
            for b in blocks:
                lb, vb, _ = self.ref(leaves, obs[:, b], reset[:, b], s0[b])
                torch.autograd.backward([lb, vb], [g_logits[:, b], g_value[:, b]])
        grads = {n: torch.zeros_like(v) if v.grad is None else v.grad for n, v in leaves.items()}
        return float(loss.detach()), grads

    def _first_step(self, chunk, state0, idx):
        opt, rec = self.opt, self.rec
        del opt.step  # the optimizer's own from here on
        t = _clock()
        named = list(self.agent.named_parameters())
        batch = chunk.map(lambda x: x[:, idx])
        s0 = state0.map(lambda x: x[idx])
        if self.control:
            rec['judged_loss'], judged = self._ref_grads(batch, s0, True)
            judged = {n: g.cpu() for n, g in judged.items()}
        else:
            judged = {n: p.grad for n, p in named}
        rec['ref_loss'], grads = self._ref_grads(batch, s0, False)
        del batch, s0

        device = named[0][1].device

        def clip(gs):
            norm = torch.sqrt(sum((g.to(device) ** 2).sum() for g in gs.values()))
            return torch.where(norm < opt.max_grad_norm, 1., opt.max_grad_norm / norm)
        c_j, c_r = clip(judged), clip(grads)
        full = lambda x: torch.full((), x, dtype=torch.float32, device=device)
        c1, c2 = 1 - full(B1) ** (opt.count + 1), 1 - full(B2) ** (opt.count + 1)

        def update(i, g):
            mu = (1 - B1) * g + B1 * opt.mu[i]
            nu = (1 - B2) * g * g + B2 * opt.nu[i]
            return mu / c1 / (torch.sqrt(torch.maximum(opt.nu_max[i], nu / c2)) + EPS) * -opt.lr
        gaps, norms, u_gaps, u_norms, targets = [], [], [], [], {}
        with torch.no_grad():
            for i, (n, p) in enumerate(named):
                g_r = grads.pop(n) * c_r
                g_j = judged[n].to(device) * c_j
                gaps.append(float((g_j - g_r).norm()))
                norms.append(float(g_r.norm()))
                u_r = update(i, g_r)
                u_norms.append(float(u_r.norm()))
                if self.control:
                    u_gaps.append(float((update(i, g_j) - u_r).norm()))
                else:
                    targets[n] = p + u_r
                del g_r, g_j, u_r
        del judged, grads
        spent = _clock() - t
        opt.step()  # the program's own work, left out of the check's seconds
        t = _clock()
        if not self.control:
            with torch.no_grad():
                u_gaps = [float((p - targets.pop(n)).norm()) for n, p in named]
        norms, gaps = np.array(norms), np.array(gaps)
        med = np.median(norms)
        counted = norms >= 1e-3 * med
        u_gaps, u_norms = np.array(u_gaps), np.array(u_norms)
        self.numbers['grad_gap'] = float((gaps / np.maximum(norms, med)).max())
        self.numbers['update_gap'] = float(np.sqrt((u_gaps[counted] ** 2).sum()
                                                   / (u_norms[counted] ** 2).sum()))
        self.numbers['grad_check_s'] = spent + _clock() - t
        names = [n for n, _ in named]
        worst = lambda gap: [(names[i], float(gap[i])) for i in np.argsort(-gap)[:3]]
        self.numbers['worst'] = dict(
            grads=worst(gaps / np.maximum(norms, med)),
            updates=worst(np.where(counted, u_gaps / np.maximum(u_norms, 1e-30), 0.)))


def numbers(checks):
    """The numbers compared for ``correct``, each beside its name: for the
    set-up's first chunk (every env resets at t = 0) and, with the suffix
    ``.later``, the later chunk:

    * ``logits_gap``, ``value_gap``: the norm of the gap of the rollout's
      log-probabilities (values) over the reference's norm;
    * ``state_gap``: per core, layer and leaf of the chunk-end state (the SSM
      state, the conv window, the live keys and values), the norm of the gap
      over the reference's norm; the worst;
    * ``memory_mismatch``: memory slots whose liveness differs;
    * ``loss_gap``: the first minibatch's loss, the gap over the reference's;
    * ``grad_gap``: per parameter, the norm of the clipped gradient's gap over
      the larger of the reference's norm and the median parameter's; the worst;
    * ``update_gap``: the norm of the update's gap over the reference
      update's norm, over every parameter but those whose reference gradient
      is under a thousandth of the median's. Not the worst parameter's: the
      first AMSGrad step moves each weight by about ``lr·sign(g)``, so a
      gradient near zero whose sign flips on rounding moves a vector of 64
      weights by a quarter of its norm;

    and ``resets_missing``: 1 if the later chunk has no reset at t > 0 (or no
    such chunk came), else 0. A chunk that was not checked reads infinity.
    """
    out = []
    for tag in TAGS:
        n = checks.get(tag) or {}
        out += [(f'{k}{tag}', float(n.get(k, math.inf))) for k in KEYS]
    inner = (checks.get('.later') or {}).get('inner_resets', 0)
    out.append(('resets_missing', 0. if inner > 0 else 1.))
    print(f'check detail: env-steps of the later chunk that reset at t > 0: {inner}; '
          f'worst parameters {[(t or "set-up", (checks.get(t) or {}).get("worst")) for t in TAGS]}',
          flush=True)
    return out


def run(c, seed, seconds, trace, device, t_start, fault=None):
    """One run of the cell; ``fault``: ``'control'`` or ``'reset'`` (readings
    only)."""
    with dropped_resets() if fault == 'reset' else contextlib.nullcontext():
        return _run(c, seed, seconds, trace, device, t_start, fault == 'control')


def _run(c, seed, seconds, trace, device, t_start, control):
    from megastep_tpu_torch import tracing
    traffic = c['traffic']
    cuda = device == 'cuda'
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    checks = {}
    split = dict(before_build_s=common.now() - t_start)
    tracing.enable()  # set-up's counters: the learner's graph captures
    try:
        proxy, agent, opt, gen, carry, step = build(c, seed, device)
        sync()
        split['build_s'] = common.now() - t_start - split['before_build_s']
        with Check(c, proxy, agent, opt, control) as check:
            carry, _ = step(carry, gen)
        checks[''] = check.numbers
        sync()
        split['checked_chunk_s'] = common.now() - t_start - sum(split.values())
        for _ in range(WARM_CHUNKS):
            carry, _ = step(carry, gen)
        sync()
    finally:
        tracing.disable()
    set_up = tracing.drain()
    # Set-up without the reference's own seconds: the check of chunk 1 runs
    # inside it, and would hide a change to the program's set-up.
    check_s = {k: checks[''].get(k, 0.) for k in ('rollout_check_s', 'grad_check_s')}
    setup_s = common.now() - t_start - sum(check_s.values())
    split['warm_s'] = setup_s + sum(check_s.values()) - sum(split.values())
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    marks = []

    def mark():
        if cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append(e)
    if trace and cuda:
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
    cfg = c['config']
    records = dict(window_s=window_s, chunks=n, samples_per_chunk=samples, n_envs=proxy.n_envs,
                   batch=traffic['batch'], minibatches=minibatches,
                   obs_shapes={k: tuple(v.shape) for k, v in proxy.obs_space.items()},
                   n_actions=proxy.action_space.shape[-1],
                   hybrid=dict(core_config(cfg), hidden_size=cfg['hidden_size']),
                   setup_counts=set_up['counts'], setup_split=split,
                   check_s=check_s)
    if marks:
        records['rollout_ms'] = [marks[3 * i].elapsed_time(marks[3 * i + 1]) for i in range(n)]
        records['learner_ms'] = [marks[3 * i + 1].elapsed_time(marks[3 * i + 2])
                                 for i in range(n)]
    if proxy.events:
        per = [s.elapsed_time(e) for s, e in proxy.events]
        b = traffic['buffer']
        records['env_step_ms'] = [sum(per[i * b:(i + 1) * b]) for i in range(n)]
    out = dict(attempted=n, failed=0,
               metrics=common.train_metrics(samples, n, window_s, setup_s), records=records,
               memory_peak_bytes=torch.cuda.max_memory_allocated() if cuda else 0)
    held = dict(carry=carry)
    del carry  # the held carry moves on; an older one would keep its state alive

    def chunk():
        held['carry'], m = step(held['carry'], gen)
        return m
    if trace:
        proxy.events = None
        for key, host in (('trace', False), ('host_trace', True)):
            held['metrics'], records[key] = common.traced(chunk, host)
            t0, t1 = records[key]['span']
            records[f'{key}_chunk_ms'] = 1e-3 * (t1 - t0)
        events, recs, _ = spans.pass_b(lambda: held.update(metrics=chunk()), device)
        table = spans.attribute(events, {s['name'] for s in recs['spans']})['spans']
        records['spans'] = {k: v for k, v in table.items() if k in SPANS}
        records['span_counts'] = recs['counts']
        records['span_minibatches'] = held['metrics']['minibatches']
        del events

    for _ in range(traffic['later_chunks']):
        with Check(c, proxy, agent, opt, control, inner=True) as check:
            chunk()
        if check.numbers is not None:
            checks['.later'] = check.numbers
            break
    out['checks'] = numbers(checks)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description='Readings that set the limits of the hybrid '
                                            'train cell\'s check')
    p.add_argument('--workload', default='explorer-train-granite-h')
    p.add_argument('--mode', default='sound', choices=('sound', 'control', 'reset'))
    p.add_argument('--seeds', required=True, help='comma-separated')
    p.add_argument('--seconds', type=float, default=None,
                   help="the window's seconds (default: BENCHMARK.json's run_seconds)")
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    spec = common.benchmark_spec()
    c = common.cell(args.workload, spec)
    seconds = spec['run_seconds'] if args.seconds is None else args.seconds
    for seed in (int(s) for s in args.seeds.split(',')):
        t0 = time.perf_counter()
        if args.device == 'cuda':
            torch.cuda.reset_peak_memory_stats()
        out = run(c, seed, seconds, 0, args.device, common.now(),
                  None if args.mode == 'sound' else args.mode)
        print(json.dumps(dict(workload=args.workload, mode=args.mode, seed=seed,
                              seconds=time.perf_counter() - t0, numbers=dict(out['checks']),
                              metrics=out['metrics'],
                              memory_peak_bytes=int(out['memory_peak_bytes']))), flush=True)
        del out
        if args.device == 'cuda':
            torch.cuda.empty_cache()


if __name__ == '__main__':
    sys.exit(main())
