"""The benchmark of ``megastep_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload explorer-train --seed 7 --seconds 51 --trace 0

Builds the cell from ``--seed`` (set-up), warms up its own shapes, measures for
``--seconds``, checks what the timed path produced against the plain reference
in ``benchmark/reference/``, and prints one JSON line last: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and ``checks``, each number compared beside its limit. The
same numbers are the last lines on standard error. It needs a CUDA device and
never falls back to the CPU.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

from benchmark import common  # noqa: E402


def card():
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                               '--format=csv,noheader'], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f'nvidia-smi unavailable: {e}'


def result(c, out, trace, spec):
    """The result's line from a driver's output (the checks last)."""
    units = {m['name']: m['unit'] for m in spec['end_to_end'] + spec['per_layer']}
    checks = {name: dict(value=value, limit=c['limits'][name]) for name, value in out['checks']}
    correct = all(math.isfinite(v['value']) and v['value'] <= v['limit']
                  for v in checks.values())
    if trace:
        metrics = {}
        for m in c['per_layer']:
            value = common.reader(m['name']).read(out['records'])
            if value is not None:
                metrics[m['name']] = dict(value=value, unit=units[m['name']])
    else:
        metrics = {name: dict(value=out['metrics'][name], unit=units[name])
                   for name in c['end_to_end']}
    line = dict(correct=correct, attempted=out['attempted'], failed=out['failed'],
                metrics=metrics, device=out['device'])
    tr = out['records'].get('trace')
    if trace and tr is not None:
        t0, t1 = tr['span']
        line['device'].update(busy_s=common.busy_share(tr) * (t1 - t0) * 1e-6,
                              window_s=(t1 - t0) * 1e-6)
        line['breakdown'] = common.breakdown(tr, out['records']['host_trace'])
    line['checks'] = checks
    return line


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # Caches of kernels the program or its libraries build, at fixed paths in
    # the checkout (the observe kernel builds into build/megastep_tpu_torch).
    os.environ['TORCH_EXTENSIONS_DIR'] = str(ROOT / 'build' / 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = str(ROOT / 'build' / 'triton')
    spec = common.benchmark_spec()
    c = common.cell(args.workload, spec)
    import torch
    chips = c['entry']['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'benchmark: the cell needs {chips} CUDA device(s); '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0} available',
              file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    out = common.driver(c).run(c, args.seed, args.seconds, args.trace, 'cuda', T_START)
    out['device'] = dict(platform='gpu', kind=torch.cuda.get_device_name(0), count=chips,
                         memory_peak_bytes=int(out['memory_peak_bytes']))
    line = result(c, out, args.trace, spec)
    print(f'card: {card()}', flush=True)
    print(f'records: { {k: v for k, v in out["records"].items() if k not in ('trace', 'host_trace')} }',
          flush=True)
    found = common.forbidden_modules()
    if found:
        print(f'benchmark: the run loaded {found}, which it may not', file=sys.stderr)
        return 3
    for name, v in line['checks'].items():
        print(f'check {name}: {v["value"]!r} (limit {v["limit"]!r})', file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
