"""The Granite-4.0-H hybrid core (``megastep_tpu_torch.models.hybrid``) against
its plain reference (``models.hybrid_reference``), on the CPU.

The JAX package has no such core, so the reference, a step-by-step loop with
explicit resets, takes the JAX package's place. The size is small (d_model 64;
Mamba-2 mixers of 8 heads of 16 at expand 2, ``d_state`` 8, conv 4; GQA of 4
query heads of 16 over 2 KV heads; MLP 128; a period of Mamba, attention,
Mamba; an 8-slot memory), the weights seeded, the start states random.

Tolerances: the port's chunked scan sums in another order than the
reference's loop (a (T, T) masked product in place of T updates) and its
one-step form fuses the update, so outputs and states are held to
allclose(rtol=1e-4, atol=1e-5), float32 rounding through three layers; the
gradients to atol 1e-5 × the largest one. Cuts at resets are held exactly:
a masked term contributes a zero, whatever the input behind it.
"""
import copy
import importlib
import inspect

import numpy as np
import pytest
import torch

from megastep_tpu_torch import tracing
from megastep_tpu_torch.arrdict import arrdict
from megastep_tpu_torch.models import Agent, hybrid, hybrid_reference as ref
from megastep_tpu_torch.rebar import fsm

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
CFG = dict(layer_types=('mamba', 'attention', 'mamba'), mamba_expand=2, mamba_n_heads=8,
           mamba_d_head=16, mamba_d_state=8, mamba_d_conv=4, num_attention_heads=4,
           num_key_value_heads=2, attention_multiplier=1 / 16, shared_intermediate_size=128,
           mem_len=8)
D, T, B = 64, 12, 6
#: Resets at t = 0 for env 0, inside the chunk for envs 1-3, none for 4-5.
RESETS = {0: [0], 1: [3], 2: [5, 9], 3: [11]}


def _config():
    full = {k: v.default for k, v in inspect.signature(hybrid.HybridCore).parameters.items()
            if v.default is not inspect.Parameter.empty and k != 'generator'}
    full.update(CFG)
    return full


def _core(seed=0):
    return hybrid.HybridCore(D, generator=torch.Generator().manual_seed(seed), **CFG)


def _inputs(seed=1, t=T):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((t, B, D), generator=g)
    reset = torch.zeros((t, B), dtype=torch.bool)
    for b, ts in RESETS.items():
        for s in ts:
            if s < t:
                reset[s, b] = True
    return x, reset


def _random_state(core, seed=2):
    """A start state with every part non-zero: SSM and conv windows, and a
    memory partly filled, with an episode start inside it."""
    g = torch.Generator().manual_seed(seed)
    state = core.initial_state(B)
    for s in state.values():
        for k in ('ssm', 'conv', 'k', 'v'):
            if k in s:
                s[k] = .3 * torch.randn(s[k].shape, generator=g)
        if 'valid' in s:
            s['valid'] = torch.rand(s.valid.shape, generator=g) < .8
            s['reset'] = torch.rand(s.reset.shape, generator=g) < .15
    return state


def _params(core):
    return dict(core.named_parameters())


def _reference(core, x, reset, state):
    return ref.core(_params(core), _config(), x, reset, ref.from_port_state(_config(), state))


def _ref_state(state):
    return ref.from_port_state(_config(), state)


def _close_states(got, want):
    for name, s in want.items():
        for k, v in s.items():
            if v.dtype == torch.bool:
                assert torch.equal(got[name][k], v), (name, k)
            else:
                torch.testing.assert_close(got[name][k], v, **TOL, msg=f'{name}.{k}')


def _steps(core, x, reset, state):
    ys = []
    for t in range(x.shape[0]):
        y, state = core(x[t:t + 1], reset[t:t + 1], state)
        ys.append(y)
    return torch.cat(ys), state


@pytest.mark.parametrize('mode', ['chunked', 'one-step'])
def test_core_matches_the_reference(mode):
    """The port's output and end state against the reference's loop, on a chunk
    with resets at t = 0 and inside it, from a random start state."""
    core = _core()
    x, reset = _inputs()
    state = _random_state(core)
    with torch.no_grad():
        want, want_state = _reference(core, x, reset, state)
        got, got_state = (core(x, reset, state) if mode == 'chunked'
                          else _steps(core, x, reset, state))
    torch.testing.assert_close(got, want, **TOL)
    _close_states(_ref_state(got_state), want_state)


def test_core_gradients_match_the_reference():
    """The chunked form's gradients, of every parameter and of the input,
    against those of the reference's loop."""
    core = _core()
    x, reset = _inputs()
    state = _random_state(core)
    w = torch.randn((T, B, D), generator=torch.Generator().manual_seed(3))
    x.requires_grad_(True)
    (core(x, reset, state)[0] * w).sum().backward()
    got = [x.grad.clone()] + [p.grad.clone() for p in core.parameters()]
    core.zero_grad()
    x.grad = None
    (_reference(core, x, reset, state)[0] * w).sum().backward()
    want = [x.grad] + [p.grad for p in core.parameters()]
    scale = max(float(g.abs().max()) for g in want)
    names = ['x'] + [n for n, _ in core.named_parameters()]
    for name, g, h in zip(names, got, want):
        torch.testing.assert_close(g, h, rtol=TOL['rtol'], atol=TOL['atol'] * scale, msg=name)


def test_one_step_calls_equal_one_chunk_call():
    """T calls of one step (the rollout's recurrent form) and one call of T
    steps (the learner's chunked form) give the same outputs and state."""
    core = _core()
    x, reset = _inputs()
    state = _random_state(core)
    with torch.no_grad():
        y1, s1 = _steps(core, x, reset, state)
        y2, s2 = core(x, reset, state)
    torch.testing.assert_close(y1, y2, **TOL)
    _close_states(s1, s2)


def test_the_state_carried_across_two_calls_equals_one_call():
    core = _core()
    x, reset = _inputs()
    state = _random_state(core)
    with torch.no_grad():
        ya, mid = core(x[:5], reset[:5], state)
        yb, end = core(x[5:], reset[5:], mid)
        y, whole = core(x, reset, state)
    torch.testing.assert_close(torch.cat([ya, yb]), y, **TOL)
    _close_states(end, whole)


@pytest.mark.parametrize('mode', ['chunked', 'one-step'])
def test_an_input_before_a_reset_changes_nothing_after_it(mode):
    """Env 2 resets at t = 5 and 9, env 0 at t = 0. Changing env 2's inputs
    before t = 9 and its whole start state (through the scan, the conv's window
    and the attention's memory) leaves its outputs from t = 9 on, and its end
    state, bit for bit as they were; changing env 0's start state changes
    none of its outputs; the other envs' outputs do not move at all."""
    core = _core()
    x, reset = _inputs()
    state = _random_state(core)
    run = (lambda *a: core(*a)) if mode == 'chunked' else (lambda *a: _steps(core, *a))
    with torch.no_grad():
        y, s = run(x, reset, state)
        x2 = x.clone()
        x2[:9, 2] += torch.randn((9, D), generator=torch.Generator().manual_seed(4))
        state2 = state.map(lambda v: v.clone())
        for layer in state2.values():
            for k, v in layer.items():
                if v.is_floating_point():
                    v[[0, 2]] += 1.
        y2, s2 = run(x2, reset, state2)
    assert not torch.equal(y2[:9, 2], y[:9, 2])
    assert torch.equal(y2[9:, 2], y[9:, 2])
    assert torch.equal(y2[:, 0], y[:, 0])
    others = [1, 3, 4, 5]
    assert torch.equal(y2[:, others], y[:, others])
    # What later steps can read of the end state: the SSM state, the conv
    # window and the live memory slots (a slot from before the reset keeps its
    # changed key, hidden).
    for layer, layer2 in zip(_ref_state(s).values(), _ref_state(s2).values()):
        live = layer.get('live')
        if live is not None:
            assert torch.equal(layer2['live'], live)
        for k, v in layer.items():
            a, b = v[[0, 2]], layer2[k][[0, 2]]
            if live is not None and k != 'live':
                a, b = a[live[[0, 2]]], b[live[[0, 2]]]
            assert torch.equal(a, b), k


def test_state_layout_and_the_ssm_counter():
    """Batch-first state leaves at their sizes; one recurrent call counts the
    bytes of SSM and conv state it reads and writes, a chunked call none."""
    core = _core()
    state = core.initial_state(B)
    assert state.layer0.ssm.shape == (B, 8, 16, 8)
    assert state.layer0.conv.shape == (B, 3, 128 + 16)
    assert state.layer1.k.shape == state.layer1.v.shape == (B, 8, 2, 16)
    x, reset = _inputs()
    tracing.enable()
    try:
        with torch.no_grad():
            core(x[:1], reset[:1], state)
        one = tracing.drain()
        with torch.no_grad():
            core(x, reset, state)
        chunk = tracing.drain()
    finally:
        tracing.disable()
    per_layer = 4 * 2 * B * (8 * 16 * 8 + 3 * 144)
    assert one['counts'] == {'ssm_state_bytes': 2 * per_layer}
    assert 'ssm_state_bytes' not in chunk['counts']
    names = [s['name'] for s in one['spans']]
    assert names == ['core.mamba', 'core.attention', 'core.mamba']


class _ReferenceCore(torch.nn.Module):
    """A port core's parameters run through the plain reference."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x, reset, state):
        y, _ = ref.core(_params(self.inner), _config(), x, reset, _ref_state(state))
        return y, state


def test_an_agent_train_step_matches_the_reference_loss_and_gradient(monkeypatch):
    """One chunk of ``make_train_step`` with a hybrid agent on an FSM env whose
    episodes end inside the chunk, the KL stop after the first minibatch: its
    loss and each parameter's gradient against ``ppo_loss`` through the
    reference core, from the same parameters, minibatch and start state."""
    train = importlib.import_module('megastep_tpu_torch.demo.train')
    env = fsm.DelayedMatchCoin(8, device='cpu')
    agent = Agent(env.obs_space, env.action_space, width=D, core='granite_hybrid',
                  core_config=CFG, generator=torch.Generator().manual_seed(0))
    before = copy.deepcopy(agent)
    opt = train.optimizer(agent.parameters())
    g = torch.Generator().manual_seed(0)
    carry = train.init_carry(env, agent, opt, g)
    # A start state with memory in it: the chunk after a first one.
    step = train.make_train_step(env, buffer_size=8, batch_size=32, kl_limit=1e9)
    carry, _ = step(carry, g)
    before.load_state_dict(agent.state_dict())
    seen = {}
    learn = train.learn

    def recorded(agent, opt, chunk, state0, batches, *a, **kw):
        seen.update(chunk=chunk, state0=state0, idx=batches[0])
        return learn(agent, opt, chunk, state0, batches, *a, **kw)
    monkeypatch.setattr(train, 'learn', recorded)
    step = train.make_train_step(env, buffer_size=8, batch_size=32, kl_limit=-1.)
    carry, metrics = step(carry, g)
    assert metrics['minibatches'] == 1
    resets = seen['chunk'].world.reset[:, seen['idx']]
    assert resets[1:].any() and not resets.all()

    refr = before
    refr.policy_core = _ReferenceCore(refr.policy_core)
    refr.value_core = _ReferenceCore(refr.value_core)
    idx = seen['idx']
    loss, _ = train.ppo_loss(refr, seen['chunk'].map(lambda x: x[:, idx]),
                             seen['state0'].map(lambda x: x[idx]))
    loss.backward()
    assert np.isclose(metrics['loss'], float(loss.detach()), rtol=1e-4, atol=1e-6)
    want = [p.grad for p in refr.parameters()]
    got = [p.grad for p in agent.parameters()]
    scale = max(float(w.abs().max()) for w in want)
    for (name, _), a, b in zip(agent.named_parameters(), got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * scale, msg=name)


def test_the_agent_takes_its_core_sizes_from_the_configuration():
    env = fsm.MatchCoin(4, device='cpu')
    agent = Agent(env.obs_space, env.action_space, width=D, core='granite_hybrid',
                  core_config=CFG, generator=torch.Generator().manual_seed(0))
    assert [l.mixer.__class__.__name__ for l in agent.policy_core.layers] == [
        'Mamba2', 'Attention', 'Mamba2']
    assert agent.value_core.layers[1].mixer.mem_len == 8
    with pytest.raises(TypeError):
        Agent(env.obs_space, env.action_space, width=16, core='lstm', core_config=dict(x=1))
    state = agent.initial_state(4)
    assert set(state.policy) == {'layer0', 'layer1', 'layer2'}
    assert isinstance(state.policy.layer1, arrdict)
