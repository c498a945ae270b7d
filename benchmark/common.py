"""What every cell of the benchmark shares: finding a cell's files by name,
seeds, the clocks, the profiler's trace read as device intervals, the
comparison numbers, and the result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Its files are found
by the names in that entry: ``configs/<config>.json`` (by the configuration's
``file``), ``traffic/<traffic>.json`` (whose ``driver`` names a module in
``drivers/``), ``limits/<cell>.json`` (the limit of each number its check
compares) and, for each per-layer metric that lists the cell, the reader
``metrics/<metric>.py``.
"""
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level module names that may not be loaded in a run: JAX, its libraries
#: and the JAX package, compared whole (the port's name begins with the JAX
#: package's).
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'megastep_tpu')
#: Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet).
F32_FLOPS = 67e12


def load_json(path):
    return json.loads(Path(path).read_text())


def benchmark_spec():
    return load_json(ROOT / 'BENCHMARK.json')


def cell(name, spec=None):
    """The cell ``name``: its entry, configuration, traffic, limits and the
    per-layer metrics that list it (or that list no cells)."""
    spec = spec or benchmark_spec()
    entry = next((w for w in spec['workloads'] if w['name'] == name), None)
    if entry is None:
        raise SystemExit(f'no workload {name!r} in BENCHMARK.json')
    config = next(c for c in spec['configs'] if c['name'] == entry['config'])
    e2e = [m['name'] for m in spec['end_to_end'] if name in m.get('workloads', [name])]
    return dict(
        name=name, entry=entry, config=load_json(ROOT / config['file']),
        traffic=load_json(HERE / 'traffic' / f'{entry["traffic"]}.json'),
        limits=load_json(HERE / 'limits' / f'{name}.json'),
        end_to_end=e2e,
        per_layer=[m for m in spec['per_layer']
                   if name in m.get('workloads', [name]) and m['moves'] in e2e])


def driver(c):
    """The module that runs the cell's traffic: ``drivers/<driver>.py``."""
    return importlib.import_module(f'benchmark.drivers.{c["traffic"]["driver"]}')


def reader(metric):
    """The per-layer reader ``metrics/<metric>.py``, loaded by its path (its
    name may hold dots)."""
    path = HERE / 'metrics' / f'{metric}.py'
    spec = importlib.util.spec_from_file_location(f'benchmark_metric_{metric}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def seeds(seed, n):
    """``n`` 32-bit seeds derived from ``seed`` (any whole number >= 0)."""
    return [int(x) for x in np.random.SeedSequence(int(seed)).generate_state(n)]


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, its libraries' or the JAX
    package's, compared as whole names."""
    return sorted({m.split('.')[0] for m in list(sys.modules)} & set(FORBIDDEN))


def now():
    return time.perf_counter()


# --- numbers -----------------------------------------------------------------

def percentile(values, q):
    """The ``q``-th percentile, linear between the closest ranks."""
    return float(np.percentile(np.asarray(values, dtype=float), q))


def step_metrics(agent_envs, periods_ms, window_s, setup_s):
    """The step cells' end-to-end metrics: agent-steps of every step of the
    window over its wall time, and set-up."""
    return dict(agent_steps_per_s=agent_envs * len(periods_ms) / window_s, setup_s=setup_s)


def train_metrics(samples_per_chunk, chunks, window_s, setup_s):
    """The train cell's end-to-end metrics: env-steps collected and learned
    in the window's whole chunks over their wall time, set-up."""
    return dict(train_steps_per_s=samples_per_chunk * chunks / window_s, setup_s=setup_s)


def mismatches(prog, ref, atol=1e-5, rtol=1e-5):
    """How many elements of ``prog`` differ from ``ref``: floats by more than
    ``atol + rtol·|ref|`` (NaN equal to NaN, inf to inf), others unequal."""
    import torch
    prog = prog.to(ref.device)
    if prog.shape != ref.shape:
        return ref.numel()
    if ref.is_floating_point():
        prog, ref = prog.float(), ref.float()
        return int((~torch.isclose(prog, ref, rtol=rtol, atol=atol, equal_nan=True)).sum())
    return int((prog != ref).sum())


# --- the profiler's trace ------------------------------------------------------

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'cuda_runtime', 'cuda_driver')
WINDOW = 'benchmark.traced_window'


def traced(fn, host):
    """Runs ``fn`` under ``torch.profiler``, the device idle before and
    drained after.

    With ``host``, host and device activity inside an annotation that spans
    the window. Without, device activity alone (far less overhead on the
    host), the window marked by a one-element fill launched first and one
    launched last.

    :return: ``(fn's result, trace)``: ``trace`` holds the window's span
        ``(t0, t1)`` in microseconds, the device operations as arrays of
        ``name``, ``ts``, ``dur``, and (with ``host``) the host operations.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    marker = torch.zeros(1, device='cuda')
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            marker.fill_(1.)
            out = fn()
            marker.fill_(2.)
            torch.cuda.synchronize()
    path = Path(os.environ.get('TMPDIR', '/tmp')) / f'benchmark-trace-{os.getpid()}.json'
    try:
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())['traceEvents']
    finally:
        path.unlink(missing_ok=True)
    return out, trace_arrays(events, host)


def trace_arrays(events, host=True):
    """The window's span and its device and host operations, from Chrome
    trace events: the span of the annotation with ``host``, else from the
    first device operation's start to the last one's end."""
    def pick(cats):
        es = [e for e in events if e.get('ph') == 'X' and e.get('cat') in cats]
        return dict(name=np.array([e['name'] for e in es], dtype=object),
                    ts=np.array([float(e['ts']) for e in es]),
                    dur=np.array([float(e['dur']) for e in es]))
    device = pick(DEVICE_CATS)
    if host:
        span = next(e for e in events if e.get('name') == WINDOW and e.get('ph') == 'X'
                    and e.get('cat') == 'user_annotation')
        t0, t1 = float(span['ts']), float(span['ts']) + float(span['dur'])
    else:
        t0, t1 = float(device['ts'].min()), float((device['ts'] + device['dur']).max())
    return dict(span=(t0, t1), device=device, host=pick(HOST_CATS) if host else None)


def busy_intervals(trace):
    """The union of the device operations' intervals inside the window, as a
    sorted list of disjoint ``(start, end)`` in microseconds."""
    t0, t1 = trace['span']
    d = trace['device']
    starts = np.clip(d['ts'], t0, t1)
    ends = np.clip(d['ts'] + d['dur'], t0, t1)
    order = np.argsort(starts, kind='stable')
    merged = []
    for s, e in zip(starts[order], ends[order]):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def busy_share(trace):
    """The share of the window in which some operation ran on the device."""
    t0, t1 = trace['span']
    return sum(e - s for s, e in busy_intervals(trace)) / (t1 - t0)


def idle_gaps(trace):
    """Every stretch of the window with nothing on the device, ``(start,
    end)``, longest first."""
    t0, t1 = trace['span']
    gaps, last = [], t0
    for s, e in busy_intervals(trace):
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if t1 > last:
        gaps.append((last, t1))
    return sorted(gaps, key=lambda g: g[0] - g[1])


def breakdown(trace, host_trace, n=10):
    """The ``n`` device operations (by name) that took most time in
    ``trace``, and the ``n`` longest idle gaps of ``host_trace``, each named
    by the host operation that overlaps it most (the shortest one among
    equals); seconds as measured."""
    d = trace['device']
    totals = {}
    for name, dur in zip(d['name'], d['dur']):
        totals[name] = totals.get(name, 0.) + dur
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
    h = host_trace['host']
    starts, ends = h['ts'], h['ts'] + h['dur']
    gaps = []
    for g0, g1 in idle_gaps(host_trace)[:n]:
        overlap = np.minimum(ends, g1) - np.maximum(starts, g0)
        label = 'nothing on the host'
        if len(overlap) and overlap.max() > 0:
            best = np.flatnonzero(overlap >= overlap.max() - 1e-9)
            label = str(h['name'][best[np.argmin(h['dur'][best])]])
        gaps.append([label[:160], (g1 - g0) * 1e-6])
    return dict(device_ops=[[str(k)[:160], v * 1e-6] for k, v in ops], idle_gaps=gaps)


def kernel_ms(trace, pattern):
    """Mean device ms a launch of the kernels whose name holds ``pattern``,
    and the launch count; ``(None, 0)`` if none ran."""
    d = trace['device']
    hit = np.array([pattern in str(n) for n in d['name']], dtype=bool)
    if not hit.any():
        return None, 0
    return float(d['dur'][hit].mean()) * 1e-3, int(hit.sum())
