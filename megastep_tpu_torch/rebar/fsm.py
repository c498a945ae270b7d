"""Vectorized finite-state-machine environments with an exact solver.

Counterpart of :mod:`megastep_tpu.rebar.fsm` (the reference ``rebar/fsm.py:29-291``):
tiny tabular MDPs, batched over envs, with tensorized transition/reward/terminal
tables, a value-iteration oracle (:meth:`FSM.solve`), a fluent :class:`Builder`,
and the canonical testbeds — the ground truth an RL algorithm is validated
against before it spends device-hours on the raycast envs.

The env follows the port's env protocol: ``reset(rng)`` and ``step(state,
decision, rng)`` over an explicit token state, with ``rng`` a ``torch.Generator``
on the env's device, so the same training loop runs on FSMs and on the raycast
envs. ``dataframe`` imports pandas when called.
"""
import numpy as np
import torch

from .. import spaces
from ..arrdict import arrdict
from ..dotdict import dotdict
from ..models.heads import categorical
from ..scene import resolve_device

__all__ = ['FSM', 'Builder', 'fsm']


class FSM:
    """A batch of identical tabular MDPs stepped in lockstep.

    :param n_envs: batch size.
    :param tables: the dotdict from :meth:`Builder.build`.
    :param device: where the tables and tokens live; ``'cuda'`` unless the
        caller says so.
    """

    def __init__(self, n_envs, tables, device='cuda'):
        self.device = resolve_device(device)
        self.n_envs = n_envs
        self.n_states = tables.n_states

        def table(x, dtype):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

        self._obs = table(tables.obs, torch.float32)
        self._trans = table(tables.trans, torch.float32)
        self._reward = table(tables.reward, torch.float32)
        self._terminal = table(tables.terminal, torch.bool)
        self._start = table(tables.start, torch.float32)
        self._indices = tables.indices
        self._names = tables.names

        self.obs_space = (spaces.MultiVector(1, tables.d_obs) if tables.d_obs
                          else spaces.MultiEmpty())
        self.action_space = spaces.MultiDiscrete(1, tables.n_actions)

    def _sample(self, weights, generator):
        """A draw per row of ``weights`` over its last axis (JAX: a categorical
        over ``log(max(weights, 1e-30))``, so a row of zeros is uniform)."""
        return categorical(torch.log(weights.clamp(min=1e-30)), generator)

    def _world(self, token, reward, reset):
        return arrdict(obs=self._obs[token][:, None], idx=token, reward=reward,
                       reset=reset, terminal=reset)

    def reset(self, rng):
        """Samples all tokens from the start distribution. Returns
        ``(state, world)``."""
        token = self._sample(self._start.expand(self.n_envs, -1), rng)
        reward = torch.zeros((self.n_envs,), device=self.device)
        reset = torch.ones((self.n_envs,), dtype=torch.bool, device=self.device)
        return arrdict(token=token), self._world(token, reward, reset)

    def step(self, state, decision, rng):
        """Transitions on ``decision.actions``; terminal successors are immediately
        re-sampled from the start distribution (reference ``fsm.py:62-77``)."""
        actions = decision.actions[:, 0]
        token = state.token
        reward = self._reward[token, actions]
        token = self._sample(self._trans[token, actions], rng)

        reset = self._terminal[token]
        restart = self._sample(self._start.expand(self.n_envs, -1), rng)
        token = torch.where(reset, restart, token)
        return arrdict(token=token), self._world(token, reward, reset)

    def solve(self, eps=1e-3, gamma=.99):
        """Exact value iteration; the ground truth to test learners against
        (reference ``fsm.py:79-91``)."""
        trans = self._trans.cpu().numpy()
        rew = self._reward.cpu().numpy()
        terminal = self._terminal.cpu().numpy()
        value = np.zeros(self.n_states)
        while True:
            succ = (value[None, None, :] * trans).sum(-1)
            q = rew + gamma * succ
            best = q.max(-1)
            best[terminal] = 0
            change = value - best
            value = best
            if np.sqrt((change**2).mean()) < eps:
                break
        return arrdict(value=value, policy=q.argmax(-1))

    def dataframe(self, **kwargs):
        """A readable table of the solved MDP (pandas is imported here)."""
        import pandas as pd
        soln = self.solve(**kwargs)
        trans = self._trans.cpu().numpy()
        successor = trans[np.arange(self.n_states), soln.policy].argmax(-1)
        df = pd.DataFrame(dict(
            name=list(self._names),
            obs=[tuple(f'{x:.2f}' for x in o) for o in self._obs.cpu().numpy()],
            term=self._terminal.cpu().numpy(),
            start=self._start.cpu().numpy(),
            value=soln.value,
            policy=soln.policy,
            successor=[self._names[i] for i in successor])).sort_index()
        df.index.name = 'idx'
        return df

    def __repr__(self):
        s, a, _ = self._trans.shape
        return f'{type(self).__name__}({s}s{a}a)'

    __str__ = __repr__


class _StateRef:
    """Fluent edge-adding handle returned by :meth:`Builder.state`."""

    __slots__ = ('_name', '_builder')

    def __init__(self, name, builder):
        self._name = name
        self._builder = builder

    def to(self, state, action=0, reward=0., weight=1.):
        self._builder._edge(self._name, state, action, reward, weight)
        return self

    def state(self, *args, **kwargs):
        return self._builder.state(*args, **kwargs)

    def build(self):
        return self._builder.build()


class Builder:
    """Declarative MDP builder with the reference's fluent surface
    (``rebar/fsm.py:139-186``) over a columnar table compiler, as the JAX
    package's: declarations and edges accumulate as flat column lists, states
    get deterministic first-seen indices, and the dense tables fill in
    vectorized writes.

    >>> Builder().state('start', obs=0., start=1.).to('end', reward=1.).build()
    """

    def __init__(self):
        self._declared = {}             # name -> (obs tuple, start weight)
        self._cols = dict(prev=[], action=[], next=[], reward=[], weight=[])

    def state(self, name, obs, start=0.):
        if isinstance(obs, (int, float, bool)):
            obs = (obs,)
        self._declared[name] = (tuple(obs), float(start))
        return _StateRef(name, self)

    def _edge(self, prev, next_, action, reward, weight):
        c = self._cols
        c['prev'].append(prev)
        c['action'].append(int(action))
        c['next'].append(next_)
        c['reward'].append(float(reward))
        c['weight'].append(float(weight))

    def _indices(self):
        """Deterministic state numbering: declared states in declaration
        order, then edge-only states (terminal sinks) in first-mention
        order."""
        order = dict.fromkeys(self._declared)
        order.update(dict.fromkeys(self._cols['prev']))
        order.update(dict.fromkeys(self._cols['next']))
        return {name: i for i, name in enumerate(order)}

    def build(self):
        indices = self._indices()
        names = np.array(list(indices))
        S = len(indices)
        acts = np.asarray(self._cols['action'], int)
        A = int(acts.max()) + 1 if len(acts) else 0
        if set(acts.tolist()) != set(range(A)):
            raise ValueError("Action set isn't contiguous")
        (d_obs,) = {len(o) for o, _ in self._declared.values()}

        # Undeclared (edge-only) states keep NaN observations: they're terminal,
        # and terminal tokens are resampled before their obs is ever read.
        obs = np.full((S, d_obs), np.nan)
        start = np.zeros(S)
        for name, (o, s0) in self._declared.items():
            obs[indices[name]] = o
            start[indices[name]] = s0

        prev = np.array([indices[p] for p in self._cols['prev']], int)
        succ = np.array([indices[nx] for nx in self._cols['next']], int)
        trans = np.zeros((S, A, S))
        reward = np.zeros((S, A))
        trans[prev, acts, succ] = self._cols['weight']
        reward[prev, acts] = self._cols['reward']

        terminal = ~trans.any(axis=(1, 2))   # no outgoing edge, any action
        if not start.sum() > 0:
            raise ValueError('No start state declared')

        return dotdict(
            obs=obs, trans=trans, reward=reward, terminal=terminal, start=start,
            indices=indices, names=names,
            n_states=S, n_actions=A, d_obs=d_obs)


def fsm(f):
    """Class factory: an FSM-description function becomes an env class
    (reference ``fsm.py:189-198``). The class takes ``(n_envs=1, *args,
    device='cuda', **kwargs)``, the rest going to ``f``."""
    def init(self, n_envs=1, *args, device='cuda', **kwargs):
        tables = f(*args, **kwargs)
        if not isinstance(tables, dict):
            raise TypeError('FSM description must be a dictionary. Did you forget '
                            'to call `.build()`?')
        FSM.__init__(self, n_envs, tables, device)

    name = f.__name__
    __all__.append(name)
    return type(name, (FSM,), {'__init__': init})


@fsm
def ObliviousConstantReward():
    return (Builder()
            .state('start', obs=(), start=1.)
            .to('end', reward=1.)
            .build())


@fsm
def ObliviousCyclicReward():
    return (Builder()
            .state('start', obs=0., start=1.).to('middle', reward=1)
            .state('middle', obs=1.).to('end', reward=0)
            .build())


@fsm
def ObliviousChain(n=2, r=1):
    if n < 2:
        raise ValueError('Need the number of states to be at least 2')
    b = Builder()
    b.state(0, obs=0., start=1.).to(1, 0)
    for i in range(1, n):
        b.state(i, obs=i / n).to(i + 1, 0, reward=(i == n - 1))
    return b.build()


@fsm
def ObliviousCoin():
    return (Builder()
            .state('heads', obs=+1., start=1.).to('end', 0, reward=+1)
            .state('tails', obs=-1., start=1.).to('end', 0, reward=-1)
            .build())


@fsm
def ObliviousDelayedCoin():
    return (Builder()
            .state('heads-1', obs=+.5, start=1.).to('heads-2')
            .state('heads-2', obs=+1.).to('end', reward=+1)
            .state('tails-1', obs=-.5, start=1.).to('tails-2')
            .state('tails-2', obs=-1.).to('end', reward=-1)
            .build())


@fsm
def DelayedMatchCoin():
    """The memory probe: the rewarded action at step 2 depends on the obs at step 1."""
    return (Builder()
            .state('heads-1', obs=+1., start=1.)
            .to('heads-2', 0).to('heads-2', 1)
            .state('heads-2', obs=0.)
            .to('end', 0, reward=+1).to('end', 1, reward=-1)
            .state('tails-1', obs=0., start=1.)
            .to('tails-2', 0).to('tails-2', 1)
            .state('tails-2', obs=-1.)
            .to('end', 0, reward=-1).to('end', 1, reward=+1)
            .build())


@fsm
def MatchCoin():
    return (Builder()
            .state('heads', obs=+1., start=1.)
            .to('end', 0, reward=+1).to('end', 1, reward=-1)
            .state('tails', obs=-1., start=1.)
            .to('end', 0, reward=-1).to('end', 1, reward=+1)
            .build())


@fsm
def RandomChain(n=2, seed=0):
    if n < 2:
        raise ValueError('Need the radius to be at least 2')
    b = Builder()
    random = np.random.RandomState(seed)
    actions = random.permutation([0, 1])
    (b.state(0, obs=0., start=1.)
     .to(0, action=actions[0])
     .to(1, action=actions[1]))
    for i in range(1, n):
        actions = random.permutation([0, 1])
        (b.state(+i, obs=+i / n)
         .to(0, action=actions[0])
         .to(i + 1, action=actions[1], reward=+(i == n - 1)))
    return b.build()
