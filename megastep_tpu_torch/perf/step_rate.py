"""Steps per second of the port's two cells on one card, and an A/B of two trees.

Each env is built as ``chip_smoke.py`` builds it: Explorer at 16,384 envs, res
256 pooled by 4; Deathmatch at 16,384 agent-envs (4,096 scenes x 4 agents), res
512 pooled by 4; both on ``floorplans.sample(512)`` tiled. Each runs its main
path (reset + 32 steps), then ``WINDOWS`` windows of ``STEPS`` steps of random
actions, each window ending in ``torch.cuda.synchronize()``. The rate is all
timed steps over their total wall time (the rate ``chip_smoke.py`` reports);
each window's ms/step is printed beside it, and the first window's rate alone,
which is how the port measured it before.

    python3 -m megastep_tpu_torch.perf.step_rate
    python3 megastep_tpu_torch/perf/step_rate.py --ab OTHER_TREE

``--ab`` runs this script in a fresh process on the package of each tree in
turn, OTHER_TREE, this tree, this tree, OTHER_TREE (each process builds its own
tree's kernels), and prints every run's lines and then the rates side by side.
It uses only the package's env API, so OTHER_TREE may be an older tree of the
port. Each process prints one ``{"step_rate": {...}}`` JSON line per env.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

N_ENVS, RES = 16384, 256                   # Explorer
DM_ENVS, DM_AGENTS, DM_RES = 16384, 4, 512  # Deathmatch agent-envs
SUBSAMPLE, N_GEOMETRIES = 4, 512
STEPS, WINDOWS = 32, 3
DEVICE = 'cuda'


def timed_windows(torch, step, windows=WINDOWS, steps=STEPS):
    """Calls ``step`` in ``windows`` windows of ``steps`` calls, each ending in
    a synchronize. Returns each window's wall seconds per call, the seconds per
    call over all of them, and the last value ``step`` returned."""
    times, out = [], None
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            out = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return [t / steps for t in times], sum(times) / (windows * steps), out


def _rate(torch, name, env, n, g_main, g_timed):
    """Main path of ``env`` from generator ``g_main``, then the timed windows,
    the actions drawn from ``g_timed``; one ``step_rate`` line."""
    from megastep_tpu_torch.arrdict import arrdict

    state, _ = env.reset(g_main)

    def step(g):
        nonlocal state
        actions = torch.randint(0, 7, (n, 1), generator=g, device=DEVICE)
        state, _ = env.step(state, arrdict(actions=actions), g)

    for _ in range(STEPS):
        step(g_main)
    torch.cuda.synchronize()
    windows, step_s, _ = timed_windows(torch, lambda: step(g_timed))
    return {'env': name, 'steps_per_s': n / step_s, 'ms_per_step': 1e3 * step_s,
            'ms_per_step_windows': [1e3 * w for w in windows],
            'first_window_steps_per_s': n / windows[0], 'n': n}


def measure():
    """Both cells' ``step_rate`` lines, as chip_smoke.py seeds them."""
    import numpy as np
    import torch
    from megastep_tpu_torch import envs, floorplans

    geoms = floorplans.sample(N_GEOMETRIES)

    def tiled(n):
        return [geoms[i % len(geoms)] for i in range(n)]

    def gen(seed):
        g = torch.Generator(device=DEVICE)
        g.manual_seed(seed)
        return g

    env = envs.Explorer(N_ENVS, geometries=tiled(N_ENVS), res=RES, subsample=SUBSAMPLE,
                        random=np.random.RandomState(0), device=DEVICE)
    g = gen(0)
    rows = [_rate(torch, 'Explorer', env, N_ENVS, g, g)]
    del env
    env = envs.Deathmatch(DM_ENVS, n_agents=DM_AGENTS,
                          geometries=tiled(DM_ENVS // DM_AGENTS), res=DM_RES,
                          subsample=SUBSAMPLE, random=np.random.RandomState(0),
                          device=DEVICE)
    rows.append(_rate(torch, 'Deathmatch', env, DM_ENVS, gen(0), gen(2)))
    return rows


def ab(other, timeout):
    """This script on ``other``'s package and this tree's, in turns."""
    here = Path(__file__).resolve().parents[2]
    other = Path(other).resolve()
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    runs = []
    for tag, tree in (('other', other), ('this', here), ('this', here), ('other', other)):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve())], cwd=tree,
                              env=dict(os.environ, PYTHONPATH=str(tree)),
                              capture_output=True, text=True, timeout=timeout)
        print(f'== {tag} tree {tree}: rc {proc.returncode}', flush=True)
        print(proc.stdout + proc.stderr[-4000:], end='', flush=True)
        if proc.returncode:
            raise RuntimeError(f'step_rate failed on {tree}')
        for line in proc.stdout.splitlines():
            if line.startswith('{"step_rate"'):
                runs.append(dict(json.loads(line)['step_rate'], tree=tag))
    for name in ('Explorer', 'Deathmatch'):
        rows = [r for r in runs if r['env'] == name]
        print(f'{name} steps/s, all windows (first window alone), in turns: '
              + '; '.join(f"{r['tree']} {r['steps_per_s']:.0f} "
                          f"({r['first_window_steps_per_s']:.0f})" for r in rows),
              flush=True)
    print(card, flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--ab', metavar='OTHER_TREE',
                        help='root of another tree of the port to compare with')
    parser.add_argument('--timeout', type=float, default=600,
                        help='seconds each process of --ab may take')
    opts = parser.parse_args()
    if opts.ab:
        ab(opts.ab, opts.timeout)
        return 0
    import torch
    if not torch.cuda.is_available():
        print('step_rate: no CUDA device', file=sys.stderr)
        return 2
    for row in measure():
        print(json.dumps({'step_rate': row}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
