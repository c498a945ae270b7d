"""Readings that set the limits of a cell's check; the benchmark's runs do
not run this.

    python3 benchmark/readings.py --workload deathmatch-step --mode control --seeds 1,2,3

For each seed it builds the cell as a run does and prints the numbers that
the check compares, as one JSON line, with the program, or something in its
place, on the judged side:

* ``sound``: the program, as a run has it;
* ``control``: the plain reference in the next lower precision than the
  configuration's: bfloat16 for the worlds' float32, TF32 for the agent's
  float32 with TF32 off;
* ``unchanged``, ``half``, ``alter``: the program (step cells) or the
  reference (the train cell) with a planted fault: the state returned
  unchanged; half of the batch left out (half of the envs unstepped; each
  minibatch's loss over half of its envs); one answer altered where it is
  produced (an env's observation; an env's reward).

Step cells run ``--steps`` steps of the cell's traffic before the check.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

from benchmark import common  # noqa: E402


class _Tables:
    def __init__(self, tables):
        self.__dict__.update(tables)


def step_reading(c, seed, mode, steps, device):
    import torch
    from benchmark.drivers import step
    from benchmark.reference import world as ref
    env, gen, keep_random = step.build(c, seed, device)
    loop = step.Loop(env, gen, keep_random, c['traffic']['kept_steps'],
                     c['config']['n_agents'], None if mode in ('sound', 'control') else mode)
    for _ in range(steps):
        loop.step()
    scenery, start = env.core.scenery, loop.start
    kept = loop.kept + [loop.last]
    del env, loop
    if mode == 'control':
        kind, low = c['config']['env'], step.reference_world(c, seed, device)
        low = ref.cast(low, torch.bfloat16)
        low['baked'] = ref.bake(low, torch.bfloat16)
        scenery = _Tables({k: (low[k].float() if low[k].is_floating_point() else low[k])
                           for k in step.SCENERY})
        s0, w0 = step.reference_reset(low, kind, start[0])
        start = (start[0], s0, w0)
        kept = [(b, a, ch) + step.reference_step(low, kind, b, a, ch, torch.bfloat16)[:2]
                for b, a, ch, _, _ in kept]
        del low
    return step.check(c, seed, device, scenery, start, kept)[0]


def train_reading(c, seed, mode, device):
    from benchmark.drivers import train
    if mode == 'sound':
        return train.run(c, seed, 0, 0, device, common.now())['checks']
    prog = train.reference(c, seed, device, tf32=mode == 'control', half=mode == 'half',
                           alter=mode == 'alter')
    return train.numbers(prog, train.reference(c, seed, device))


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--mode', required=True,
                   choices=('sound', 'control', 'unchanged', 'half', 'alter'))
    p.add_argument('--seeds', required=True, help='comma-separated')
    p.add_argument('--steps', type=int, default=200)
    p.add_argument('--device', default='cuda')
    args = p.parse_args()
    c = common.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(',')):
        t0 = time.perf_counter()
        if c['traffic']['driver'] == 'train':
            numbers = train_reading(c, seed, args.mode, args.device)
        else:
            numbers = step_reading(c, seed, args.mode, args.steps, args.device)
        print(json.dumps(dict(workload=args.workload, mode=args.mode, seed=seed,
                              seconds=time.perf_counter() - t0, numbers=dict(numbers))),
              flush=True)


if __name__ == '__main__':
    main()
