"""The frozen counts against what they count: the agent's FLOPs against
``torch.utils.flop_counter`` on the port's agent, and the observe's bytes and
operations against the port's own roofline arithmetic."""
import importlib

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counts import work


def _agent(width, R):
    from megastep_tpu_torch import spaces
    from megastep_tpu_torch.dotdict import dotdict
    from megastep_tpu_torch.models import Agent
    obs = dotdict(rgb=spaces.MultiImage(1, 3, 1, R), d=spaces.MultiImage(1, 1, 1, R),
                  imu=spaces.MultiVector(1, 3))
    agent = Agent(obs, spaces.MultiDiscrete(1, 7), width=width,
                  generator=torch.Generator().manual_seed(0))
    shapes = {k: tuple(v.shape) for k, v in obs.items()}
    return agent, shapes


def _world(T, B, R):
    from megastep_tpu_torch.arrdict import arrdict
    g = torch.Generator().manual_seed(1)
    obs = arrdict(rgb=torch.rand((T, B, 1, 3, 1, R), generator=g),
                  d=torch.rand((T, B, 1, 1, 1, R), generator=g),
                  imu=torch.rand((T, B, 1, 3), generator=g))
    return arrdict(obs=obs, reset=torch.zeros((T, B), dtype=torch.bool))


@pytest.mark.parametrize('width,R', [(16, 64), (32, 40)])
def test_agent_forward_flops_match_the_counter(width, R):
    agent, shapes = _agent(width, R)
    T, B = 3, 5
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        agent(_world(T, B, R), agent.initial_state(B), value=True)
    forward, _ = work.agent(shapes, 7, width)
    assert fc.get_total_flops() == T * B * forward


def test_agent_training_flops_match_the_counter():
    """A learner minibatch's forward and backward, as the train step runs it,
    within the recurrent core's first step (whose state needs no gradient)."""
    train = importlib.import_module('megastep_tpu_torch.demo.train')
    width, R, T, B = 16, 64, 8, 6
    agent, shapes = _agent(width, R)
    world = _world(T, B, R)
    with torch.no_grad():
        d, _ = agent(world, agent.initial_state(B), generator=torch.Generator().manual_seed(2),
                     sample=True, value=True)
    from megastep_tpu_torch.arrdict import arrdict
    world['reward'] = torch.rand((T, B))
    batch = arrdict(world=world, decision=d)
    with FlopCounterMode(display=False) as fc:
        loss, _ = train.ppo_loss(agent, batch, agent.initial_state(B))
        loss.backward()
    forward, first = work.agent(shapes, 7, width)
    counted = T * B * work.train_sample(forward, first)
    assert fc.get_total_flops() == pytest.approx(counted, rel=1 / T)
    assert fc.get_total_flops() <= counted


def test_observe_counts_match_the_ports_arithmetic():
    from megastep_tpu_torch import envs
    from megastep_tpu_torch.ops import fused
    from megastep_tpu_torch.perf import roofline
    from benchmark.inputs import floorplans
    plans = floorplans.sample(3, 4)
    for kind in ('Explorer', 'Deathmatch'):
        n = 6 if kind == 'Explorer' else 8
        kw = dict(n_agents=4) if kind == 'Deathmatch' else {}
        env = getattr(envs, kind)(n, geometries=floorplans.tiled(plans, n // (4 if kw else 1)),
                                  res=64, random=np.random.RandomState(0), device='cpu', **kw)
        state, _ = env.reset(torch.Generator().manual_seed(0))
        args, kwargs = env.observe_args(state.agents)
        out = fused.observe(*args, **kwargs)
        scn = env.core.scenery
        skip = kwargs.get('skip_dyn', 0)
        t_dyn = kwargs['baked_dyn'].shape[1] if kwargs.get('baked_dyn') is not None else 0
        theirs = roofline.observe_counts(scn, out, skip, t_dyn, fast_div=False)
        N, A, R = out.indices.shape
        live = int((scn.lines_width - skip).sum())
        hits = int((out.indices >= 0).sum())
        nbytes, ops = work.observe(N, A, R, live, hits, t_dyn,
                                   out.seen.numel() if 'seen' in out else None)
        assert nbytes == theirs['bytes']
        assert ops == theirs['ops'] + theirs['divides']
        ms, _ = roofline.roofline_ms(theirs['bytes'], theirs['ops'] + theirs['divides'])
        assert work.roofline_ms(nbytes, ops) == pytest.approx(ms)
