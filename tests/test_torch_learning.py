"""The port's RL math (``megastep_tpu_torch.demo.learning``) against the JAX
package's (``megastep_tpu.demo.learning``), on the CPU.

Every function takes the same (T=32, B=8) inputs, made from a numpy seed, with
episode resets at about one step in five; outputs are held to
allclose(rtol=1e-5, atol=1e-6). V-trace is also held to the naive O(T²) oracle
``v_trace_ref`` of either package at the same tolerance.
"""
import numpy as np
import pytest
import torch

from megastep_tpu_torch.demo import learning

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
T, B, GAMMA = 32, 8, .99


@pytest.fixture(scope='module')
def jlearning():
    jax_learning = pytest.importorskip('megastep_tpu.demo.learning')
    return jax_learning


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    return dict(value=rs.randn(T, B).astype(np.float32),
                reward=rs.randn(T, B).astype(np.float32),
                reset=rs.rand(T, B) < .2,
                ratios=np.exp(rs.randn(T, B) * .5).astype(np.float32))


def _both(x):
    import jax.numpy as jnp
    return torch.from_numpy(np.asarray(x)), jnp.asarray(x)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize('seed', [0, 1])
def test_deltas_and_returns_match_jax(jlearning, seed):
    x = _inputs(seed)
    (value, jvalue), (reward, jreward), (reset, jreset) = (
        _both(x[k]) for k in ('value', 'reward', 'reset'))
    _close(learning.deltas(value, reward, value, reset, GAMMA),
           jlearning.deltas(jvalue, jreward, jvalue, jreset, GAMMA))
    _close(learning.present_value(reward[1:], value[-1], reset[1:], .9),
           jlearning.present_value(jreward[1:], jvalue[-1], jreset[1:], .9))
    _close(learning.generalized_advantages(value, reward, value, reset, GAMMA),
           jlearning.generalized_advantages(jvalue, jreward, jvalue, jreset, GAMMA))
    _close(learning.reward_to_go(reward, value, reset, GAMMA),
           jlearning.reward_to_go(jreward, jvalue, jreset, GAMMA))


@pytest.mark.parametrize('max_rho,max_c', [(1, 1), (2., .5)])
def test_v_trace_matches_jax_and_the_oracle(jlearning, max_rho, max_c):
    x = _inputs(2)
    (ratios, jratios), (value, jvalue), (reward, jreward), (reset, jreset) = (
        _both(x[k]) for k in ('ratios', 'value', 'reward', 'reset'))
    got = learning.v_trace(ratios, value, reward, reset, GAMMA, max_rho, max_c)
    _close(got, jlearning.v_trace(jratios, jvalue, jreward, jreset, GAMMA, max_rho, max_c))
    for ref in (learning.v_trace_ref, jlearning.v_trace_ref):
        # The oracle takes one env's (T,) series.
        want = np.stack([ref(*(x[k][:, b] for k in ('ratios', 'value', 'reward', 'reset')),
                             GAMMA, max_rho, max_c) for b in range(B)], 1)
        _close(got, want)


def test_returns_carry_no_gradient():
    """GAE, returns and V-trace are targets: the JAX package stops their
    gradients, the port detaches them."""
    x = _inputs(3)
    value = torch.from_numpy(x['value']).requires_grad_()
    reward, reset = torch.from_numpy(x['reward']), torch.from_numpy(x['reset'])
    ratios = torch.from_numpy(x['ratios']).requires_grad_()
    for out in (learning.generalized_advantages(value, reward, value, reset, GAMMA),
                learning.reward_to_go(reward, value, reset, GAMMA),
                learning.v_trace(ratios, value, reward, reset, GAMMA)):
        assert not out.requires_grad


def test_gather_and_flatten_match_jax(jlearning):
    import jax.numpy as jnp
    from megastep_tpu.dotdict import dotdict as jdotdict
    from megastep_tpu_torch.dotdict import dotdict

    rs = np.random.RandomState(4)
    logits = {k: rs.randn(T, B, 1, n).astype(np.float32) for k, n in (('a', 7), ('b', 3))}
    actions = {k: rs.randint(0, v.shape[-1], (T, B, 1)) for k, v in logits.items()}
    got = learning.flatten(learning.gather(
        dotdict({k: torch.from_numpy(v) for k, v in logits.items()}),
        dotdict({k: torch.from_numpy(v) for k, v in actions.items()})))
    want = jlearning.flatten(jlearning.gather(
        jdotdict({k: jnp.asarray(v) for k, v in logits.items()}),
        jdotdict({k: jnp.asarray(v) for k, v in actions.items()})))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (T, B, 2)


def test_batch_indices_partition_the_envs():
    """Each env lands in exactly one minibatch of ``batch_size // T`` envs, in
    an order drawn from the generator (the JAX package draws it from a key)."""
    g = torch.Generator().manual_seed(0)
    batches = learning.batch_indices(40, 256, T, g)
    assert [len(b) for b in batches] == [8] * 5
    np.testing.assert_array_equal(np.sort(torch.cat(batches).numpy()), np.arange(40))
    again = learning.batch_indices(40, 256, T, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(batches, again))
