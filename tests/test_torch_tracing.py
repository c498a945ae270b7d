"""The port's spans and counters (``megastep_tpu_torch.tracing``) on the CPU:
off, they cost one check and call nothing; on, they nest, count and, under
``torch.profiler``, stand in its trace as user annotations; a train step
records what each layer did and computes the same bits either way."""
import importlib
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from megastep_tpu_torch import floorplans, kernels, toys, tracing
from megastep_tpu_torch.envs import Deathmatch, Explorer
from megastep_tpu_torch.models import Agent
from megastep_tpu_torch.rebar import fsm

# The module, not the ``train`` function its package exports under that name.
train = importlib.import_module('megastep_tpu_torch.demo.train')

torch.set_num_threads(1)

N_ENVS, BUFFER, BATCH = 4, 4, 8  # 2 minibatches of 2 env columns
LEARN = ('learn.forward', 'learn.backward', 'learn.optimizer', 'learn.kl_read')


@pytest.fixture(autouse=True)
def fresh():
    """Every test starts and ends with tracing off and nothing recorded."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def names(records):
    return [s['name'] for s in records['spans']]


def explorer(seed=0):
    return Explorer(N_ENVS, geometries=floorplans.sample(N_ENVS, seed=7), res=64, subsample=1,
                    random=np.random.RandomState(seed), device='cpu')


def built(seed=0, kl_limit=.02):
    """A tiny Explorer train step and its carry, all drawn from ``seed``."""
    env = explorer(seed)
    agent = Agent(env.obs_space, env.action_space, width=16,
                  generator=torch.Generator().manual_seed(seed))
    opt = train.optimizer(agent.parameters(), lr=3e-4)
    gen = torch.Generator().manual_seed(seed)
    carry = train.init_carry(env, agent, opt, gen)
    step = train.make_train_step(env, buffer_size=BUFFER, batch_size=BATCH, kl_limit=kl_limit)
    return step, carry, gen


def test_off_span_is_the_shared_no_op_and_calls_nothing():
    calls = []

    def watch(frame, event, arg):
        calls.append((event, getattr(arg, '__name__', None) or frame.f_code.co_name))
    sys.setprofile(watch)
    try:
        s = tracing.span('a')
        with s:
            tracing.count('n')
    finally:
        sys.setprofile(None)
    assert s is tracing.OFF
    # Only tracing's own Python functions ran: no builtin, no torch call.
    assert not [c for c in calls if c[0].startswith('c_') and c[1] != 'setprofile'], calls
    assert {c[1] for c in calls if c[0] == 'call'} <= {'span', 'count', '__enter__', '__exit__'}
    assert tracing.drain() == dict(spans=[], counts={})


def test_on_spans_nest_with_their_parents_and_counters_add():
    tracing.enable()
    with tracing.span('a'):
        with tracing.span('b'):
            tracing.count('n')
            with tracing.span('c'):
                tracing.count('n', 2)
        with tracing.span('d'):
            pass
    with tracing.span('e'):
        tracing.count('m')
    tracing.disable()
    with tracing.span('off'):
        tracing.count('n')
    rec = tracing.drain()
    assert names(rec) == ['a', 'b', 'c', 'd', 'e']
    assert [s['parent'] for s in rec['spans']] == [None, 0, 1, 0, None]
    assert rec['counts'] == {'n': 3, 'm': 1}
    for s in rec['spans']:
        assert s['start_ns'] <= s['end_ns']
        if s['parent'] is not None:
            p = rec['spans'][s['parent']]
            assert p['start_ns'] <= s['start_ns'] and s['end_ns'] <= p['end_ns']
    assert tracing.drain() == dict(spans=[], counts={})


def test_drain_inside_an_open_span_raises_and_enable_starts_afresh():
    tracing.enable()
    with tracing.span('a'):
        with pytest.raises(RuntimeError, match="'a'"):
            tracing.drain()
    tracing.disable()
    tracing.enable()  # from off: a new recording
    assert tracing.drain() == dict(spans=[], counts={})


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f'record_function({name!r}) entered with no profiler')
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    tracing.enable()
    with tracing.span('a'):
        pass
    assert names(tracing.drain()) == ['a']


@pytest.mark.parametrize('kl_limit', [1e9, -1.], ids=['every-minibatch', 'stop-after-first'])
def test_a_train_step_records_each_layer(kl_limit):
    step, carry, gen = built(kl_limit=kl_limit)
    tracing.enable()
    carry, metrics = step(carry, gen)
    rec = tracing.drain()
    spans = rec['spans']
    count = {n: names(rec).count(n) for n in set(names(rec))}
    ran = int(metrics['minibatches'])
    assert ran == (2 if kl_limit > 1 else 1)
    assert count.pop('rollout.agent') == BUFFER and count.pop('env.step') == BUFFER
    for n in LEARN:
        assert count.pop(n) == ran, n
    assert count == {'train.chunk': 1, 'train.rollout': 1, 'train.learn': 1,
                     'train.metrics_read': 1}
    assert rec['counts'] == {'host_syncs': ran + 1}
    parent = {s['name']: spans[s['parent']]['name'] if s['parent'] is not None else None
              for s in spans}
    assert parent == {'train.chunk': None, 'train.rollout': 'train.chunk',
                      'rollout.agent': 'train.rollout', 'env.step': 'train.rollout',
                      'train.learn': 'train.chunk', 'train.metrics_read': 'train.chunk',
                      **{n: 'train.learn' for n in LEARN}}


def test_a_hybrid_train_step_records_its_mixers_and_the_state_it_moves():
    """With the hybrid core, each Mamba-2 mixer call is a ``core.mamba`` span
    and the attention's a ``core.attention`` span, inside ``rollout.agent``
    and ``learn.forward``; ``ssm_state_bytes`` counts the SSM and conv state
    that the rollout's one-step calls read and write, and the learner's
    chunked calls add nothing to it."""
    cfg = dict(layer_types=('mamba', 'attention', 'mamba'), mamba_n_heads=4, mamba_d_head=8,
               mamba_d_state=4, num_attention_heads=2, num_key_value_heads=1,
               shared_intermediate_size=32, mem_len=4)
    env = fsm.MatchCoin(N_ENVS, device='cpu')
    agent = Agent(env.obs_space, env.action_space, width=16, core='granite_hybrid',
                  core_config=cfg, generator=torch.Generator().manual_seed(0))
    opt = train.optimizer(agent.parameters())
    gen = torch.Generator().manual_seed(0)
    carry = train.init_carry(env, agent, opt, gen)
    step = train.make_train_step(env, buffer_size=BUFFER, batch_size=BATCH, kl_limit=1e9)
    tracing.enable()
    carry, metrics = step(carry, gen)
    rec = tracing.drain()
    spans = rec['spans']
    parents = {}
    for s in spans:
        if s['name'].startswith('core.'):
            parents.setdefault(s['name'], []).append(spans[s['parent']]['name'])
    calls = BUFFER + int(metrics['minibatches'])  # both cores each time
    assert sorted(parents['core.mamba']) == sorted(
        ['rollout.agent'] * 4 * BUFFER + ['learn.forward'] * 4 * int(metrics['minibatches']))
    assert len(parents['core.attention']) == 2 * calls
    ssm = 4 * 8 * 4 + 3 * (2 * 16 + 2 * 4)  # H·P·N and (K−1)·conv width, a mixer and env
    assert rec['counts']['ssm_state_bytes'] == BUFFER * 4 * N_ENVS * ssm * 4 * 2


def test_set_up_and_the_deathmatch_step_record_their_spans():
    tracing.enable()
    env = Deathmatch(8, n_agents=4, geometries=[toys.box(), toys.box()], res=64,
                     subsample=1, random=np.random.RandomState(0), device='cpu')
    setup = tracing.drain()
    assert names(setup) == ['scene.scenery', 'spawns.tables']
    gen = torch.Generator().manual_seed(0)
    state, world = env.reset(gen)
    tracing.drain()
    actions = torch.randint(0, 7, (env.n_envs, 1), generator=gen)
    env.step(state, train.arrdict(actions=actions), gen)
    rec = tracing.drain()
    assert names(rec) == ['env.step', 'env.rebake']
    assert [s['parent'] for s in rec['spans']] == [None, 0]


def test_kernel_build_span_only_when_it_compiles(tmp_path, monkeypatch):
    (tmp_path / 'csrc').mkdir()
    (tmp_path / 'csrc' / 'k.cu').write_text('// a kernel\n')
    monkeypatch.setattr(kernels, 'CSRC', tmp_path / 'csrc')
    monkeypatch.setattr(kernels, 'BUILD', tmp_path / 'build')
    monkeypatch.setattr(kernels, 'nvcc', lambda: 'nvcc')

    def compile_(cmd, **kw):
        open(cmd[cmd.index('-o') + 1], 'w').close()
        return subprocess.CompletedProcess(cmd, 0, stdout='')
    monkeypatch.setattr(kernels.subprocess, 'run', compile_)
    tracing.enable()
    assert kernels.build('k') == ''
    assert kernels.build('k') is None  # built already: no compile, no span
    assert names(tracing.drain()) == ['kernels.build']


def _annotations(prof, tmp_path):
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())['traceEvents']
    return sorted((e for e in events if e.get('ph') == 'X' and e.get('cat') == 'user_annotation'),
                  key=lambda e: float(e['ts']))


def test_a_profiler_trace_holds_every_span_inside_its_parent(tmp_path):
    step, carry, gen = built()
    tracing.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(carry, gen)
    rec = tracing.drain()
    ann = _annotations(prof, tmp_path)
    # The k-th span entered is the k-th annotation by start.
    assert [e['name'] for e in ann] == names(rec)
    for e, s in zip(ann, rec['spans']):
        if s['parent'] is None:
            continue
        p = ann[s['parent']]
        t0, t1 = float(e['ts']), float(e['ts']) + float(e['dur'])
        assert float(p['ts']) <= t0 and t1 <= float(p['ts']) + float(p['dur']), e['name']


def _leaves(x):
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k])
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def test_the_step_computes_the_same_bits_with_tracing_on_and_off():
    outs = []
    for on in (False, True):
        step, carry, gen = built(seed=3)
        if on:
            tracing.enable()
        history = []
        for _ in range(2):
            carry, metrics = step(carry, gen)
            history.append(metrics)
        tracing.disable()
        state = dict(params=dict(carry.agent.named_parameters()),
                     opt={k: v for k, v in carry.opt.state_dict().items() if k != 'count'},
                     env_state=carry.env_state, world=carry.world,
                     agent_state=carry.agent_state)
        outs.append((history, list(_leaves(state)), carry.opt.count))
    (h0, s0, c0), (h1, s1, c1) = outs
    assert h0 == h1 and c0 == c1
    assert len(s0) == len(s1) > 0
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))


def test_the_profiled_chunk_of_train_names_the_layers(tmp_path, monkeypatch):
    from megastep_tpu_torch.rebar import paths
    monkeypatch.setattr(paths, 'ROOT', str(tmp_path / 'traces'))
    train.train(fsm.MatchCoin(8, device='cpu'), buffer_size=4, batch_size=16, width=8,
                steps=2, run_name='prof', profile=1)
    (trace,) = paths.subdirectory('prof', 'profile').iterdir()
    events = json.loads(trace.read_text())['traceEvents']
    found = {e['name'] for e in events if e.get('cat') == 'user_annotation'}
    assert {'train.chunk', 'train.rollout', 'rollout.agent', 'train.learn',
            'learn.forward', 'learn.backward', 'learn.optimizer', 'learn.kl_read',
            'train.metrics_read'} <= found
    # The spans were on for that chunk alone, and nothing was kept.
    assert not tracing.enabled()
    assert tracing.drain() == dict(spans=[], counts={})
