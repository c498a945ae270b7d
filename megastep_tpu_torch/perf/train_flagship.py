"""The reference flagship train config, sustained on one GPU.

Counterpart of the JAX package's ``perf/train_flagship.py``: 8,192 Explorer envs
on 512 procedural floorplans (tiled), res 256 pooled by 4, a 32-step buffer,
16,384-sample minibatches, a 256-wide LSTM agent, AMSGrad(3e-4) behind a
norm-100 clip and the KL stop at 0.02 (``megastep_tpu/demo/train.py:265-267``,
reference ``megastep/demo/__init__.py:109-116``). Runs ``--chunks`` training
chunks after one warm-up chunk and prints sustained env-steps/s of the whole
train step (actor plus learner, host clock ending in a sync), the rollout and
learner ms per chunk (CUDA events), and the reward trend. Usage::

    python -m megastep_tpu_torch.perf.train_flagship --chunks 20
    python -m megastep_tpu_torch.perf.train_flagship --kind deathmatch \\
        --envs 4096 --batch 8192 --chunks 10   # agent-steps/s

:func:`build` makes the env, agent, optimizer, train step and carry; the smoke
run (``chip_smoke.py``) builds its train phase through it.
"""
import argparse
import time

import numpy as np
import torch

from .. import floorplans
from ..arrdict import arrdict
from ..demo.train import init_carry, make_train_step, optimizer
from ..envs import Deathmatch, Explorer
from ..models import Agent
from ..scene import resolve_device

N_GEOMETRIES = 512


def build(kind='explorer', n_envs=8 * 1024, buffer_size=32, batch_size=16 * 1024,
          width=256, core='lstm', lr=3e-4, seed=0, device='cuda', geometries=None,
          core_config=None, **kwargs):
    """The flagship config's env, agent, optimizer, train step and carry.

    :param kind: 'explorer', or 'deathmatch' (``n_envs`` agent-envs, 4 agents a
        scene).
    :param geometries: the floorplans, tiled over the scenes; ``None`` means
        ``floorplans.sample(512)``, as the JAX script takes.
    :param core_config: the core's sizes (:class:`~..models.Agent`'s).
    :param kwargs: the env's own (e.g. ``res``, ``subsample``).
    :return: arrdict(env, agent, opt, step, carry, generator).
    """
    device = resolve_device(device)
    n_scenes = max(n_envs // 4, 1) if kind == 'deathmatch' else n_envs
    if geometries is None:
        geometries = floorplans.sample(min(n_scenes, N_GEOMETRIES))
    geometries = [geometries[i % len(geometries)] for i in range(n_scenes)]
    random = np.random.RandomState(seed)
    if kind == 'deathmatch':
        env = Deathmatch(n_envs, n_agents=4, geometries=geometries, random=random,
                         device=device, **kwargs)
    else:
        env = Explorer(n_envs, geometries=geometries, random=random, device=device,
                       **kwargs)
    agent = Agent(env.obs_space, env.action_space, width=width, core=core,
                  generator=torch.Generator().manual_seed(seed),
                  core_config=core_config).to(device)
    opt = optimizer(agent.parameters(), lr)
    generator = torch.Generator(device).manual_seed(seed)
    carry = init_carry(env, agent, opt, generator)
    step = make_train_step(env, buffer_size=buffer_size, batch_size=batch_size)
    return arrdict(env=env, agent=agent, opt=opt, step=step, carry=carry,
                   generator=generator)


def timed_chunks(run, n):
    """Runs ``n`` chunks of ``run`` (from :func:`build`), timing each chunk's
    rollout and learner with CUDA events. Returns the chunks' metrics, their
    total seconds on the host clock (ending in a sync), and the per-chunk
    rollout and learner ms."""
    events = []

    def mark():
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        events.append(event)

    history = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        run['carry'], metrics = run.step(run.carry, run.generator, mark)
        history.append(metrics)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rollout_ms = [events[i].elapsed_time(events[i + 1]) for i in range(0, 3 * n, 3)]
    learner_ms = [events[i + 1].elapsed_time(events[i + 2]) for i in range(0, 3 * n, 3)]
    return history, seconds, rollout_ms, learner_ms


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--chunks', type=int, default=20)
    p.add_argument('--envs', type=int, default=8 * 1024)
    p.add_argument('--buffer', type=int, default=32)
    p.add_argument('--batch', type=int, default=16 * 1024)
    p.add_argument('--width', type=int, default=256)
    p.add_argument('--kind', choices=['explorer', 'deathmatch'], default='explorer')
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('train_flagship: no CUDA device')

    t0 = time.perf_counter()
    run = build(args.kind, args.envs, args.buffer, args.batch, args.width)
    timed_chunks(run, 1)
    print(f'build + first chunk: {time.perf_counter() - t0:.1f} s', flush=True)

    history, seconds, rollout_ms, learner_ms = timed_chunks(run, args.chunks)
    rewards = [m['traj_reward'] for m in history]
    steps = args.envs * args.buffer * args.chunks
    print(f'{torch.cuda.get_device_name(0)}: {steps / seconds:,.0f} '
          f'{"agent" if args.kind == "deathmatch" else "env"}-steps/s over '
          f'{args.chunks} chunks; rollout {np.mean(rollout_ms):.1f} ms, learner '
          f'{np.mean(learner_ms):.1f} ms per chunk; minibatches run '
          f'{[int(m["minibatches"]) for m in history]}; '
          f'traj_reward first→last: {rewards[0]:.3f} → {np.mean(rewards[-3:]):.3f}; '
          f'peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB', flush=True)


if __name__ == '__main__':
    main()
