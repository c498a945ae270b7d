"""Multi-GPU scaling harness.

Counterpart of :mod:`megastep_tpu.parallel.scaling`. :func:`measure` runs the
sharded train step (:mod:`.mesh`) over ``n_devices`` ranks, one process and one
GPU a rank over NCCL, and returns env-steps/s; :func:`main` compares the full
world with one GPU at the same per-GPU load. Every rank builds only its slice
of the envs (:mod:`.host`), so the ranks share nothing but the learner's
collectives.

NCCL takes one GPU a rank: asking for more ranks than GPUs raises. With one GPU
there is no scaling figure to take, and :func:`main` prints the one-GPU rate
alone. ``device='cpu'`` runs gloo ranks on the host instead, for tests. Usage::

    python -m megastep_tpu_torch.parallel.scaling --envs 65536 --devices 4
"""
import argparse
import tempfile
import time
from pathlib import Path

import torch

from ..rebar import processes


def rank_rate(m, n_envs, width=256, buffer_size=32, steps=3, res=256, subsample=4,
              seed=0, batch_size=None):
    """On this rank of mesh ``m``: the best env-steps/s (of all ``n_envs``) of
    ``steps`` sharded train chunks after a warm-up one, each timed on the host
    clock and ended by a sync."""
    from .. import floorplans
    from ..demo.train import optimizer
    from ..models import Agent
    from .host import sharded_explorer
    from .mesh import init_sharded

    geoms = floorplans.sample(min(n_envs, 512))
    geoms = [geoms[i % len(geoms)] for i in range(n_envs)]
    env = sharded_explorer(n_envs, m, geoms, seed=seed, res=res, subsample=subsample)
    agent = Agent(env.obs_space, env.action_space, width=width,
                  generator=torch.Generator().manual_seed(seed)).to(m.device)
    opt = optimizer(agent.parameters())
    generator = torch.Generator(m.device).manual_seed(seed + m.rank)
    carry, step = init_sharded(env, agent, opt, generator, m, buffer_size=buffer_size,
                               batch_size=batch_size or buffer_size * n_envs // 2)
    carry, _ = step(carry, generator)
    best = 0.
    for _ in range(steps):
        _sync(m.device)
        t0 = time.perf_counter()
        carry, _ = step(carry, generator)
        _sync(m.device)
        best = max(best, n_envs * buffer_size / (time.perf_counter() - t0))
    return best


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _rank(rank, world, init_method, backend, device, out, kwargs):
    from .mesh import mesh
    if device == 'cuda':
        device = f'cuda:{rank}'
        torch.cuda.set_device(device)
    with processes.processgroup(backend, init_method, world, rank):
        rate = rank_rate(mesh(device), **kwargs)
    if rank == 0:
        Path(out).write_text(repr(rate))


def measure(n_envs, n_devices=None, width=256, buffer_size=32, steps=3, res=256,
            subsample=4, seed=0, batch_size=None, device='cuda'):
    """Env-steps/s of the sharded train step over ``n_devices`` ranks.

    :param n_devices: ranks, one GPU each over NCCL (default: every GPU).
    :param batch_size: the global minibatch; default half the chunk. Pass the
        flagship 16,384 to compare with ``perf/train_flagship.py``.
    :param device: ``'cuda'``, or ``'cpu'`` for gloo ranks on the host (tests).
    :return: dict with ``steps_per_s``, ``n_devices`` and ``n_envs``.
    """
    if device == 'cuda':
        available = torch.cuda.device_count()
        if not available:
            raise RuntimeError("no CUDA device: pass device='cpu' for gloo ranks on the host")
        n_devices = n_devices or available
        if n_devices > available:
            raise ValueError(f'{n_devices} ranks need {n_devices} GPUs, and this machine '
                             f'has {available}: NCCL takes one GPU a rank')
        backend = 'nccl'
    else:
        n_devices, backend = n_devices or 1, 'gloo'
    kwargs = dict(n_envs=n_envs, width=width, buffer_size=buffer_size, steps=steps,
                  res=res, subsample=subsample, seed=seed, batch_size=batch_size)
    with tempfile.TemporaryDirectory(prefix='scaling_') as tmp:
        out = Path(tmp) / 'rate'
        torch.multiprocessing.spawn(
            _rank, args=(n_devices, f'file://{tmp}/store', backend, device, str(out),
                         kwargs), nprocs=n_devices)
        rate = float(out.read_text())
    return dict(steps_per_s=rate, n_devices=n_devices, n_envs=n_envs)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--envs', type=int, default=64 * 1024)
    p.add_argument('--devices', type=int, default=None)
    p.add_argument('--batch', type=int, default=None,
                   help='learner minibatch (default: half the chunk); pass '
                        '16384 for a train_flagship-matched comparison')
    args = p.parse_args(argv)

    full = measure(args.envs, args.devices, batch_size=args.batch)
    n_dev = full['n_devices']
    if n_dev > 1:
        single = measure(args.envs // n_dev, 1,
                         batch_size=args.batch and args.batch // n_dev)
        eff = full['steps_per_s'] / (single['steps_per_s'] * n_dev)
        print(f"1 device: {single['steps_per_s']:,.0f} steps/s")
        print(f"{n_dev} devices: {full['steps_per_s']:,.0f} steps/s "
              f"-> scaling efficiency {eff:.1%}")
    else:
        print(f"1 device: {full['steps_per_s']:,.0f} steps/s")


if __name__ == '__main__':
    main()
