"""The port's full-carry checkpoints (``megastep_tpu_torch.parallel.checkpoint``),
the optimizer's state, and ``train(full_checkpoint=...)``, as
``tests/test_checkpoint.py`` holds the JAX package's orbax module, on the CPU.

Exact throughout: a restored carry equals the saved one tensor for tensor
(``torch.equal``), optimizer moments and count included. The JAX comparison
holds a restored ``ClippedAMSGrad`` against an uninterrupted
``optax.chain(clip_by_global_norm(100), amsgrad(3e-4))`` at allclose(rtol=1e-5,
atol=1e-6), as ``tests/test_torch_train.py`` holds the optimizer.
"""
import importlib

import numpy as np
import pytest
import torch

from megastep_tpu_torch.arrdict import arrdict
from megastep_tpu_torch.parallel import checkpoint
from megastep_tpu_torch.rebar import fsm, paths

# The module, not the ``train`` function its package exports under that name.
train = importlib.import_module('megastep_tpu_torch.demo.train')

torch.set_num_threads(1)

RUN = dict(buffer_size=4, batch_size=16, width=8)
OPT_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def root(tmp_path, monkeypatch):
    monkeypatch.setattr(paths, 'ROOT', str(tmp_path / 'traces'))
    return tmp_path


def _leaves(x, where=''):
    """(path, leaf) pairs of a carry: tensors, and the state dicts of the
    objects that have one."""
    if hasattr(x, 'state_dict'):
        x = x.state_dict()
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f'{where}.{k}')
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _leaves(v, f'{where}[{i}]')
    else:
        yield where, x


def assert_carries_equal(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert x == y, path


def _carry(seed=0, scale=1.):
    g = torch.Generator().manual_seed(seed)
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        for p in lin.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * scale)
    opt = train.optimizer(lin.parameters())
    return arrdict(agent=lin, opt=opt,
                   env_state=arrdict(token=torch.arange(4, dtype=torch.int32) * seed,
                                     seen=torch.rand((4, 5), generator=g) > .5),
                   world=arrdict(obs=torch.randn((4, 1, 3), generator=g)),
                   agent_state=arrdict(policy=arrdict(h=torch.randn((4, 2), generator=g))))


def test_save_restore_roundtrip(tmp_path):
    carry = _carry(1)
    carry.agent(torch.ones(2, 3)).sum().backward()
    carry.opt.step()
    assert checkpoint.save(tmp_path / 'ck', 3, carry) == 3
    assert checkpoint.latest_step(tmp_path / 'ck') == 3
    assert sorted(p.name for p in (tmp_path / 'ck').iterdir()) == ['3.pt']
    target = _carry(2, scale=0.)
    restored = checkpoint.restore(tmp_path / 'ck', target)
    assert restored.agent is target.agent and restored.opt is target.opt
    assert restored.opt.count == 1
    assert_carries_equal(restored, carry)


def test_restore_missing_gives_none(tmp_path):
    assert checkpoint.restore(tmp_path / 'none', _carry()) is None
    assert checkpoint.latest_step(tmp_path / 'none') is None


def test_only_the_newest_three_are_kept(tmp_path):
    carry = _carry()
    for step in (1, 2, 5, 3, 9):
        checkpoint.save(tmp_path / 'ck', step, carry)
    assert sorted(int(p.stem) for p in (tmp_path / 'ck').glob('*.pt')) == [3, 5, 9]
    assert checkpoint.latest_step(tmp_path / 'ck') == 9
    target = _carry(4)
    checkpoint.restore(tmp_path / 'ck', target, step=5)
    assert_carries_equal(target.agent, carry.agent)


@pytest.mark.parametrize('change', ['shape', 'dtype', 'missing', 'extra', 'opt'])
def test_a_mismatched_target_raises(tmp_path, change):
    checkpoint.save(tmp_path / 'ck', 1, _carry())
    target = _carry()
    if change == 'shape':
        target['world'] = arrdict(obs=torch.zeros((4, 1, 4)))
    elif change == 'dtype':
        target['env_state']['token'] = target.env_state.token.long()
    elif change == 'missing':
        del target['agent_state']
    elif change == 'extra':
        target['world']['more'] = torch.zeros(4)
    else:
        target['opt'] = train.optimizer(torch.nn.Linear(3, 3).parameters())
    with pytest.raises(ValueError):
        checkpoint.restore(tmp_path / 'ck', target)


def test_optimizer_state_dict_continues_as_jax(tmp_path):
    """Two steps, a save and a restore into a fresh optimizer, two more steps:
    the parameters follow optax's chain stepped four times unbroken."""
    optax = pytest.importorskip('optax')
    jnp = pytest.importorskip('jax.numpy')
    rng = np.random.RandomState(0)
    w0 = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32) * s for s in (1, 300, .1, 2)]

    tx = optax.chain(optax.clip_by_global_norm(100.), optax.amsgrad(3e-4))
    jw = jnp.asarray(w0)
    state = tx.init(jw)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, jw)
        jw = optax.apply_updates(jw, updates)

    p = torch.nn.Parameter(torch.tensor(w0))
    opt = train.optimizer([p])
    for g in grads[:2]:
        p.grad = torch.tensor(g)
        opt.step()
    checkpoint.save(tmp_path / 'ck', 2, arrdict(opt=opt, w=p.detach()))
    q = torch.nn.Parameter(torch.zeros(5, 3))
    fresh = train.optimizer([q])
    restored = checkpoint.restore(tmp_path / 'ck', arrdict(opt=fresh, w=q.detach()))
    with torch.no_grad():
        q.copy_(restored.w)
    assert fresh.count == 2
    for g in grads[2:]:
        q.grad = torch.tensor(g)
        fresh.step()
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jw), **OPT_TOL)


def test_train_full_checkpoint_resume(root):
    """As ``tests/test_checkpoint.py::test_train_full_checkpoint_resume``: the
    whole carry is saved, a fresh ``train(steps=0)`` restores it tensor for
    tensor, and a resumed run numbers its checkpoints on to 4."""
    ckpt = str(root / 'carry-ckpt')
    carry1, _ = train.train(fsm.MatchCoin(8, device='cpu'), steps=2, run_name='ck-run-1',
                            full_checkpoint=ckpt, checkpoint_every=2, **RUN)
    assert checkpoint.latest_step(ckpt) == 2
    carry2, history = train.train(fsm.MatchCoin(8, device='cpu'), steps=0, run_name='ck-run-2',
                                  full_checkpoint=ckpt, **RUN)
    assert history == []
    assert carry2.opt.count == carry1.opt.count >= 2
    assert_carries_equal(carry2, carry1)
    assert carry2.opt.params[0] is next(carry2.agent.parameters())

    train.train(fsm.MatchCoin(8, device='cpu'), steps=2, run_name='ck-run-3',
                full_checkpoint=ckpt, checkpoint_every=2, **RUN)
    assert checkpoint.latest_step(ckpt) == 4
