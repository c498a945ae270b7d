"""The port's networks (``megastep_tpu_torch.models``) against the JAX package's
flax modules (``megastep_tpu.models``), on the CPU.

Each flax module is initialised from a JAX key, its parameters go through
``interop.agent_params_from_numpy`` into the port's module, and both run on the
same inputs made from a numpy seed. Single layers (heads, the LSTM, the
transformer's pieces) are held to allclose(rtol=1e-5, atol=1e-5); the whole
``Agent`` over a T=8 chunk with resets, both cores, at the widths of the
flagship config (256), to allclose(rtol=1e-4, atol=1e-5). ``visibility`` must
match exactly. Fresh parameters are checked against flax's distributions.
"""
import numpy as np
import pytest
import torch

from megastep_tpu_torch import interop, spaces
from megastep_tpu_torch.arrdict import arrdict
from megastep_tpu_torch.dotdict import dotdict
from megastep_tpu_torch.models import Agent, heads, lstm, transformer

torch.set_num_threads(1)

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
AGENT_TOL = dict(rtol=1e-4, atol=1e-5)
T, B, W = 8, 4, 64
#: The flax Agent at width 256 over Explorer's spaces holds this many.
EXPLORER_AGENT_PARAMS = 2_240_392


@pytest.fixture(scope='module')
def jax_models():
    pytest.importorskip('megastep_tpu.models')
    import jax
    import jax.numpy as jnp
    from megastep_tpu import spaces as jspaces
    from megastep_tpu.arrdict import arrdict as jarrdict
    from megastep_tpu.dotdict import dotdict as jdotdict
    from megastep_tpu.models import Agent as JAgent, heads as jheads
    from megastep_tpu.models import lstm as jlstm, transformer as jtransformer
    return dotdict(jax=jax, jnp=jnp, spaces=jspaces, arrdict=jarrdict, dotdict=jdotdict,
                   Agent=JAgent, heads=jheads, lstm=jlstm, transformer=jtransformer)


def _explorer_spaces(sp, dd, width=W):
    return (dd(rgb=sp.MultiImage(1, 3, 1, width), d=sp.MultiImage(1, 1, 1, width),
               imu=sp.MultiVector(1, 3)),
            sp.MultiDiscrete(1, 7))


def _obs(rs, lead=(T, B)):
    return dict(rgb=rs.rand(*lead, 1, 3, 1, W).astype(np.float32),
                d=rs.rand(*lead, 1, 1, 1, W).astype(np.float32),
                imu=rs.randn(*lead, 1, 3).astype(np.float32))


def _load(jm, module, params):
    return interop.agent_params_from_numpy(jm.jax.tree_util.tree_map(np.asarray, params),
                                           module)


def _flax(jm, module, *args, **kwargs):
    """A flax module's params (from key 0) and its output on ``args``."""
    params = module.init(jm.jax.random.PRNGKey(0), *args, **kwargs)['params']
    return params, module.apply({'params': params}, *args, **kwargs)


def _close(got, want, tol=LAYER_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize('head', ['vector', 'image', 'concat', 'discrete', 'dict', 'value'])
def test_heads_match_flax(jax_models, head):
    jm = jax_models
    rs = np.random.RandomState(0)
    obs = _obs(rs)
    jobs, obs_ = _explorer_spaces(jm.spaces, jm.dotdict), _explorer_spaces(spaces, dotdict)
    x = rs.randn(T, B, 32).astype(np.float32)
    cases = {
        'vector': (lambda s, h: h.intake(s.MultiVector(2, 3), 32), rs.randn(T, B, 2, 3)),
        'image': (lambda s, h: h.intake(s.MultiImage(2, 3, 1, W), 32),
                  rs.rand(T, B, 2, 3, 1, W)),
        'concat': (None, obs),
        'discrete': (lambda s, h: h.output(s.MultiDiscrete(2, 5), 32), x),
        'dict': (None, x),
        'value': (lambda s, h: h.ValueOutput(32), x)}
    make, inp = cases[head]
    if head == 'concat':
        jmod, mod = jm.heads.intake(jobs[0], 32), heads.intake(obs_[0], 32)
        jin = jm.arrdict({k: jm.jnp.asarray(v) for k, v in inp.items()})
        tin = arrdict({k: torch.from_numpy(v) for k, v in inp.items()})
    else:
        if head == 'dict':
            jmod = jm.heads.output(jm.dotdict(move=jm.spaces.MultiDiscrete(1, 7),
                                              aim=jm.spaces.MultiDiscrete(1, 3)), 32)
            mod = heads.output(dotdict(move=spaces.MultiDiscrete(1, 7),
                                       aim=spaces.MultiDiscrete(1, 3)), 32)
        else:
            jmod, mod = make(jm.spaces, jm.heads), make(spaces, heads)
        inp = np.asarray(inp, np.float32)
        jin, tin = jm.jnp.asarray(inp), torch.from_numpy(inp)
    params, want = _flax(jm, jmod, jin)
    got = _load(jm, mod, params)(tin)
    if isinstance(want, dict):
        assert list(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])
    else:
        _close(got, want)


def test_concat_intake_order_is_sorted_keys():
    """flax freezes the space dict into a FrozenDict with sorted keys, so the JAX
    intake concatenates d, imu, rgb; the port must too."""
    obs_space, _ = _explorer_spaces(spaces, dotdict)
    assert list(obs_space) == ['rgb', 'd', 'imu']
    assert heads.intake(obs_space, 8).keys == ['d', 'imu', 'rgb']


def test_sample_draws_from_the_generator():
    logits = torch.log_softmax(torch.randn(64, 1, 7, generator=torch.Generator().manual_seed(0)), -1)
    a = heads.MultiDiscreteOutput.sample(logits, torch.Generator().manual_seed(1))
    b = heads.MultiDiscreteOutput.sample(logits, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.shape == (64, 1)
    assert torch.equal(heads.MultiDiscreteOutput.sample(logits, None, test=True),
                       logits.argmax(-1))
    # A near-certain action is always drawn.
    sure = torch.full((64, 1, 7), -1e4).index_fill_(-1, torch.tensor([3]), 0.)
    assert (heads.MultiDiscreteOutput.sample(sure, torch.Generator().manual_seed(2)) == 3).all()


def test_uint8_images_scale_through_div(jax_models):
    """A uint8 image is scaled by a true division by 255 (``ops.geom.div``),
    and the intake then matches flax's on the same bytes."""
    from megastep_tpu_torch.ops.geom import div
    jm = jax_models
    raw = np.random.RandomState(7).randint(0, 256, (T, B, 2, 3, 1, W)).astype(np.uint8)
    jmod = jm.heads.intake(jm.spaces.MultiImage(2, 3, 1, W), 32)
    params, want = _flax(jm, jmod, jm.jnp.asarray(raw))
    mod = _load(jm, heads.intake(spaces.MultiImage(2, 3, 1, W), 32), params)
    got = mod(torch.from_numpy(raw))
    _close(got, want)
    assert torch.equal(got, mod(div(torch.from_numpy(raw).float(), 255.)))


def test_gumbel_draw_floors_a_zero_as_jax_does(jax_models):
    """A uniform draw of exactly 0 gets jax.random.categorical's floor, the
    smallest normal f32 (``jax._src.random._gumbel``), and so finite noise: the
    action it belongs to can still be picked."""
    jnp = jax_models.jnp
    logits = torch.tensor([[10., 0., 0.], [0., 0., 0.], [0., 3., 0.]])
    u = torch.tensor([[0., .5, .5], [0., .5, .25], [.1, 0., .9]])
    tiny = jnp.finfo(jnp.float32).tiny
    ju = jnp.maximum(jnp.asarray(u.numpy()), tiny)
    want = jnp.argmax(jnp.asarray(logits.numpy()) - jnp.log(-jnp.log(ju)), -1)
    got = heads.categorical(logits, u)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [0, 1, 2]        # row 0 picks the action whose draw is 0
    # From a generator, the same floor holds: the draws are finite.
    g = torch.Generator().manual_seed(0)
    assert heads.categorical(logits, g).shape == (3,)


def _lstm_inputs(seed):
    rs = np.random.RandomState(seed)
    return rs.randn(T, B, 32).astype(np.float32), rs.rand(T, B) < .25


def test_lstm_matches_flax_and_carries_state(jax_models):
    jm = jax_models
    x, reset = _lstm_inputs(1)
    jmod = jm.lstm.LSTM(32)
    rs = np.random.RandomState(2)
    h0, c0 = (rs.randn(B, 32).astype(np.float32) for _ in range(2))
    jstate = jm.arrdict(h=jm.jnp.asarray(h0), c=jm.jnp.asarray(c0))
    params, (want, wstate) = _flax(jm, jmod, jm.jnp.asarray(x), jm.jnp.asarray(reset), jstate)
    mod = _load(jm, lstm.LSTM(32), params)
    state = arrdict(h=torch.from_numpy(h0), c=torch.from_numpy(c0))
    got, gstate = mod(torch.from_numpy(x), torch.from_numpy(reset), state)
    _close(got, want)
    _close(gstate.h, wstate.h)
    _close(gstate.c, wstate.c)
    assert not gstate.h.requires_grad and not gstate.c.requires_grad

    # Two calls of T/2, the state carried between them, give the same outputs.
    first, mid = mod(torch.from_numpy(x[:T // 2]), torch.from_numpy(reset[:T // 2]), state)
    second, end = mod(torch.from_numpy(x[T // 2:]), torch.from_numpy(reset[T // 2:]), mid)
    _close(torch.cat([first, second]), want)
    _close(end.c, wstate.c)


def test_lstm_reset_zeroes_the_state():
    """From a reset step on, the outputs are those of a fresh run from a zero
    state: nothing crosses the episode boundary."""
    x, _ = _lstm_inputs(3)
    mod = lstm.LSTM(32, torch.Generator().manual_seed(0))
    reset = torch.zeros((T, B), dtype=torch.bool)
    reset[3] = True
    g = torch.Generator().manual_seed(1)
    busy = arrdict(h=torch.randn(B, 32, generator=g), c=torch.randn(B, 32, generator=g))
    got, _ = mod(torch.from_numpy(x), reset, busy)
    fresh, _ = mod(torch.from_numpy(x[3:]), torch.zeros((T - 3, B), dtype=torch.bool),
                   mod.initial_state(B))
    torch.testing.assert_close(got[3:], fresh, rtol=0, atol=0)


def test_visibility_and_embedding_match_jax(jax_models):
    jm = jax_models
    rs = np.random.RandomState(4)
    M = 6
    mem_reset, mem_valid, reset = rs.rand(M, B) < .3, rs.rand(M, B) < .7, rs.rand(T, B) < .3
    want = jm.transformer.visibility(*(jm.jnp.asarray(a) for a in (mem_reset, mem_valid, reset)), 5)
    got = transformer.visibility(*(torch.from_numpy(a) for a in (mem_reset, mem_valid, reset)), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pos = np.arange(40, dtype=np.float32)
    _close(transformer.positional_embedding(torch.from_numpy(pos), 32),
           jm.transformer.positional_embedding(jm.jnp.asarray(pos), 32), dict(rtol=1e-5, atol=1e-6))


def test_attention_frequencies_are_a_buffer_with_the_same_bits():
    """The attention's frequencies live on the module as a float64 buffer,
    left out of the state dict, so that its forward copies nothing from the
    host; the embedding from it equals the one made from numpy, bit for bit."""
    attn = transformer.Attention(32, mem_len=6, generator=torch.Generator().manual_seed(0))
    assert attn.inv_freq.dtype == torch.float64 and 'inv_freq' not in attn.state_dict()
    pos = torch.arange(40, dtype=torch.float32)
    torch.testing.assert_close(
        transformer.positional_embedding(pos, 32, inv_freq=attn.inv_freq),
        transformer.positional_embedding(pos, 32), rtol=0, atol=0)


def test_transformer_matches_flax_over_two_chunks(jax_models):
    """The second chunk attends over the first's memory, with resets in both."""
    jm = jax_models
    rs = np.random.RandomState(5)
    xs = rs.randn(2, T, B, 32).astype(np.float32)
    resets = rs.rand(2, T, B) < .2
    jmod = jm.transformer.Transformer(32, mem_len=6, n_layers=2, n_head=2)
    jstate = jmod.initial_state(B)
    params = jmod.init(jm.jax.random.PRNGKey(0), jm.jnp.asarray(xs[0]),
                       jm.jnp.asarray(resets[0]), jstate)['params']
    mod = _load(jm, transformer.Transformer(32, mem_len=6, n_layers=2, n_head=2), params)
    state = mod.initial_state(B)
    for x, reset in zip(xs, resets):
        want, jstate = jmod.apply({'params': params}, jm.jnp.asarray(x),
                                  jm.jnp.asarray(reset), jstate)
        got, state = mod(torch.from_numpy(x), torch.from_numpy(reset), state)
        _close(got, want)
        for layer in ('layer0', 'layer1'):
            _close(state[layer].m, jstate[layer].m)
            for k in ('reset', 'valid'):
                np.testing.assert_array_equal(state[layer][k].numpy(),
                                              np.asarray(jstate[layer][k]))


@pytest.mark.parametrize('core', ['lstm', 'transformer'])
def test_agent_matches_flax(jax_models, core):
    """The flagship-width agent (256) over Explorer's spaces: every flax
    parameter lands, and a T=8 chunk with resets, run from a busy state, gives
    the same logits, values and new state."""
    jm = jax_models
    rs = np.random.RandomState(6)
    obs, reset = _obs(rs), rs.rand(T, B) < .2
    jobs_space, jact = _explorer_spaces(jm.spaces, jm.dotdict)
    obs_space, act = _explorer_spaces(spaces, dotdict)
    jagent = jm.Agent(jobs_space, jact, width=256, core=core)
    jworld = jm.arrdict(obs=jm.arrdict({k: jm.jnp.asarray(v) for k, v in obs.items()}),
                        reset=jm.jnp.asarray(reset))
    world = arrdict(obs=arrdict({k: torch.from_numpy(v) for k, v in obs.items()}),
                    reset=torch.from_numpy(reset))
    params = jagent.init(jm.jax.random.PRNGKey(0), jworld, jagent.initial_state(B),
                         value=True)['params']
    agent = _load(jm, Agent(obs_space, act, width=256, core=core), params)
    n = sum(p.numel() for p in agent.parameters())
    assert n == sum(np.asarray(p).size for p in jm.jax.tree_util.tree_leaves(params))
    if core == 'lstm':
        assert n == EXPLORER_AGENT_PARAMS

    # Warm the state on one chunk, then compare the next.
    _, jstate = jagent.apply({'params': params}, jworld, jagent.initial_state(B), value=True)
    _, state = agent(world, agent.initial_state(B), value=True)
    want, jnew = jagent.apply({'params': params}, jworld, jstate, value=True)
    got, new = agent(world, state, value=True)
    _close(got.logits, want.logits, AGENT_TOL)
    _close(got.value, want.value, AGENT_TOL)
    for (_, a), (_, b) in zip(sorted(_flat(new)), sorted(_flat(jnew))):
        _close(a.float(), np.asarray(b, np.float32), AGENT_TOL)


def _flat(tree, path=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f'{path}/{k}')
        else:
            yield f'{path}/{k}', v


def test_agent_params_from_numpy_raises_on_mismatch(jax_models):
    jm = jax_models
    jobs_space, jact = _explorer_spaces(jm.spaces, jm.dotdict)
    obs_space, act = _explorer_spaces(spaces, dotdict)
    jagent = jm.Agent(jobs_space, jact, width=16)
    world = jm.arrdict(obs=jm.arrdict({k: jm.jnp.asarray(v) for k, v in
                                       _obs(np.random.RandomState(0), (1, 2)).items()}),
                       reset=jm.jnp.zeros((1, 2), bool))
    params = jm.jax.tree_util.tree_map(
        np.asarray, jagent.init(jm.jax.random.PRNGKey(0), world, jagent.initial_state(2),
                                value=True)['params'])
    params = {k: dict(v) for k, v in params.items()}
    agent = Agent(obs_space, act, width=16)
    extra = dict(params, stray={'kernel': np.zeros((16, 16), np.float32)})
    with pytest.raises(KeyError, match='no place'):
        interop.agent_params_from_numpy(extra, agent)
    short = {k: v for k, v in params.items() if k != 'value_out'}
    with pytest.raises(KeyError, match='not in the flax tree'):
        interop.agent_params_from_numpy(short, agent)
    with pytest.raises(ValueError, match='shape'):
        interop.agent_params_from_numpy(params, Agent(obs_space, act, width=8))


def test_fresh_parameters_take_flax_distributions():
    """lecun_normal kernels (a 256-wide Dense's std within 5% of 1/16), zero
    biases, per-gate orthogonal LSTM recurrences, the GTrXL gate bias at 2 and
    unit-normal attention biases."""
    obs_space, act = _explorer_spaces(spaces, dotdict)
    agent = Agent(obs_space, act, width=256, generator=torch.Generator().manual_seed(0))
    kernel = agent.policy_intake.rgb.Dense_1.weight.detach()
    assert kernel.shape == (256, 256)
    assert abs(float(kernel.std()) * 16 - 1) < .05
    assert float(kernel.abs().max()) <= 2 / 16 / .87962566103423978 + 1e-6  # truncated at 2σ
    for name, p in agent.named_parameters():
        if name.endswith('bias'):
            assert not p.any(), name
    eye = torch.eye(256)
    for block in agent.policy_core.wh.weight.chunk(4, 0):
        torch.testing.assert_close(block @ block.T, eye, rtol=0, atol=1e-4)
    gated = Agent(obs_space, act, width=64, core='transformer',
                  generator=torch.Generator().manual_seed(1)).policy_core.layer0
    assert (gated.attn_gate.b == 2).all() and (gated.ff_gate.b == 2).all()
    assert abs(float(gated.attn.k_bias.detach().std()) - 1) < .25
    again = Agent(obs_space, act, width=256, generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.policy_intake.rgb.Dense_1.weight, kernel)
