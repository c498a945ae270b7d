"""The program's own spans (``megastep_tpu_torch.tracing``) read on the card:
host time, device time, launches and idle time inside each span of a cell.

    python3 benchmark/spans.py --workload explorer-train --seed 7

builds the cell as its driver does, with the program's spans on for the
build (the set-up spans) and off for the warm-up; times a window of chunks
(or blocks of steps) with tracing off; then runs

* **pass A**: spans on, no profiler, one drain a chunk (or step): each span's
  host time, the ``host_syncs`` counter, how much of a span its children
  cover, and the wall time a chunk or step with tracing on, against the
  window's;
* **pass B**: spans on under ``torch.profiler`` with CPU and CUDA activity.
  Each device operation goes to the innermost span that holds its launching
  runtime or driver call, matched by the trace's correlation id; each launch
  and each idle stretch of the device goes to the innermost span open at its
  time, whatever the thread (autograd launches the backward's kernels from a
  thread of its own while the main thread waits inside ``learn.backward``).

It prints the table as one JSON line.
The benchmark's runs do not run this; ``launches.train`` and ``launches.step``
read :func:`launches` from a run's own traced pass.
"""
import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if __name__ == '__main__':
    sys.path[0] = str(ROOT)

from benchmark import common  # noqa: E402

#: Host calls that launch a kernel: the runtime's ``cudaLaunchKernel``,
#: ``cudaLaunchKernelExC``, the driver's ``cuLaunchKernel``, ``cuLaunchKernelEx``.
LAUNCH = 'LaunchKernel'
#: Launches of ``common.traced``'s window that are not the traced work: the
#: one-element fill launched first and the one launched last.
MARKER_LAUNCHES = 2
OUTSIDE = '(outside spans)'


def launches(trace):
    """Kernel launches of the traced work in a host-and-device trace of
    :func:`common.traced` (``trace['host']`` holds the runtime and driver
    calls of every thread): the calls whose name holds :data:`LAUNCH` inside
    the window, less its two marker fills; None without host activity."""
    if trace is None or trace.get('host') is None:
        return None
    t0, t1 = trace['span']
    h = trace['host']
    inside = (h['ts'] >= t0) & (h['ts'] <= t1)
    hit = np.array([LAUNCH in str(n) for n in h['name']], dtype=bool)
    return int((hit & inside).sum()) - MARKER_LAUNCHES


# --- span instances on the trace's clock -------------------------------------

def span_instances(events, names):
    """The user annotations named in ``names``, as span instances sorted by
    start: ``name``, ``t0``, ``t1`` (microseconds) and ``parent`` (the index
    of the instance that holds it, or -1), nesting taken from containment."""
    anns = sorted(((e['name'], float(e['ts']), float(e['ts']) + float(e['dur']))
                   for e in events if e.get('ph') == 'X' and e.get('cat') == 'user_annotation'
                   and e.get('name') in names), key=lambda a: (a[1], -a[2]))
    out, stack = [], []
    for name, t0, t1 in anns:
        while stack and out[stack[-1]]['t1'] <= t0:
            stack.pop()
        out.append(dict(name=name, t0=t0, t1=t1, parent=stack[-1] if stack else -1))
        stack.append(len(out) - 1)
    return out


def timeline(instances):
    """The innermost span open at each time, as ``(starts, owners)``: from
    ``starts[k]`` to ``starts[k + 1]`` the innermost open span is instance
    ``owners[k]`` (-1: none)."""
    starts, owners, stack = [], [], []

    def close_until(t):
        while stack and instances[stack[-1]]['t1'] <= t:
            j = stack.pop()
            starts.append(instances[j]['t1'])
            owners.append(stack[-1] if stack else -1)
    for i, s in enumerate(instances):
        close_until(s['t0'])
        starts.append(s['t0'])
        owners.append(i)
        stack.append(i)
    close_until(float('inf'))
    return np.array(starts, dtype=float), np.array(owners, dtype=int)


def owner_at(line, times):
    """The innermost span instance open at each of ``times`` (-1: none)."""
    starts, owners = line
    times = np.asarray(times, dtype=float)
    if not len(starts):
        return np.full(len(times), -1)
    k = np.searchsorted(starts, times, side='right') - 1
    return np.where(k >= 0, owners[np.clip(k, 0, None)], -1)


def split_by_owner(line, a, b, into):
    """Adds the length of ``[a, b)`` that each innermost span holds to
    ``into[owner]`` (``into[-1]``: outside every span)."""
    starts, owners = line
    k = int(np.searchsorted(starts, a, side='right')) - 1
    t = a
    while t < b:
        nxt = starts[k + 1] if k + 1 < len(starts) else float('inf')
        end = min(b, nxt)
        owner = owners[k] if k >= 0 else -1
        into[owner] = into.get(owner, 0.) + (end - t)
        t, k = end, k + 1


# --- pass B: the trace put down to spans -------------------------------------

def attribute(events, names):
    """Pass B's table from Chrome trace ``events`` and the program's span
    ``names``: for each span name, ``n`` (instances), ``host_ms`` (their
    summed length), and, counting what lies inside it and its children
    (``*_self``: what no child holds), ``device_ms`` (the device operations
    launched inside it, matched by correlation id), ``launches`` (kernel-launch
    calls of any thread inside it by time) and ``idle_ms`` (the device idle
    while it was the innermost open span). ``OUTSIDE`` holds what no span
    holds, with the device operations that took most time there by name.
    The device's window runs from the first span's start to the later of the
    last span's end and the last device operation's end."""
    inst = span_instances(events, names)
    line = timeline(inst)
    device = [e for e in events if e.get('ph') == 'X' and e.get('cat') in common.DEVICE_CATS]
    calls = [e for e in events if e.get('ph') == 'X'
             and e.get('cat') in ('cuda_runtime', 'cuda_driver')]
    launch_ts = {}
    for e in calls:
        corr = e.get('args', {}).get('correlation')
        if corr is not None:
            launch_ts[corr] = float(e['ts'])
    dev_self, outside_ops = {}, {}
    matched = [e for e in device if e.get('args', {}).get('correlation') in launch_ts]
    unmatched = sum(float(e['dur']) for e in device) - sum(float(e['dur']) for e in matched)
    owners = owner_at(line, [launch_ts[e['args']['correlation']] for e in matched])
    for e, owner in zip(matched, owners.tolist()):
        dev_self[owner] = dev_self.get(owner, 0.) + float(e['dur'])
        if owner == -1:
            outside_ops[e['name']] = outside_ops.get(e['name'], 0.) + float(e['dur'])
    launch_calls = [float(e['ts']) for e in calls if LAUNCH in e.get('name', '')]
    launch_self = {}
    for owner in owner_at(line, launch_calls):
        launch_self[int(owner)] = launch_self.get(int(owner), 0) + 1
    idle_self, gaps = {}, []
    if inst:
        t0 = min(s['t0'] for s in inst)
        t1 = max([s['t1'] for s in inst] + [float(e['ts']) + float(e['dur']) for e in device])
        trace = dict(span=(t0, t1), device=dict(
            ts=np.array([float(e['ts']) for e in device]),
            dur=np.array([float(e['dur']) for e in device])))
        for a, b in common.idle_gaps(trace):
            into = {}
            split_by_owner(line, a, b, into)
            for owner, length in into.items():
                idle_self[owner] = idle_self.get(owner, 0.) + length
            top = max(into, key=into.get)
            gaps.append([inst[top]['name'] if top >= 0 else OUTSIDE, (b - a) * 1e-3])
    # Instances follow their parents: add each one's totals into its parent's.
    n = len(inst)
    totals = {k: np.zeros(n) for k in ('device', 'launches', 'idle')}
    for k, d in (('device', dev_self), ('launches', launch_self), ('idle', idle_self)):
        for i, v in d.items():
            if i >= 0:
                totals[k][i] = v
    selfs = {k: v.copy() for k, v in totals.items()}
    for i in range(n - 1, -1, -1):
        p = inst[i]['parent']
        if p >= 0:
            for v in totals.values():
                v[p] += v[i]
    table = {}
    for i, s in enumerate(inst):
        row = table.setdefault(s['name'], dict(n=0, host_ms=0., device_ms=0., device_self_ms=0.,
                                               launches=0, launches_self=0, idle_ms=0.,
                                               idle_self_ms=0.))
        row['n'] += 1
        row['host_ms'] += (s['t1'] - s['t0']) * 1e-3
        row['device_ms'] += totals['device'][i] * 1e-3
        row['device_self_ms'] += selfs['device'][i] * 1e-3
        row['launches'] += int(totals['launches'][i])
        row['launches_self'] += int(selfs['launches'][i])
        row['idle_ms'] += totals['idle'][i] * 1e-3
        row['idle_self_ms'] += selfs['idle'][i] * 1e-3
    table[OUTSIDE] = dict(device_ms=dev_self.get(-1, 0.) * 1e-3,
                          launches=launch_self.get(-1, 0), idle_ms=idle_self.get(-1, 0.) * 1e-3,
                          device_ops=[[str(k)[:100], v * 1e-3] for k, v in sorted(
                              outside_ops.items(), key=lambda kv: -kv[1])[:5]])
    gaps.sort(key=lambda g: -g[1])
    return dict(spans=table, unmatched_device_ms=unmatched * 1e-3,
                device_ms=sum(float(e['dur']) for e in device) * 1e-3,
                launches=len(launch_calls),
                kernels=sum(1 for e in device if e.get('cat') == 'kernel'),
                longest_idle=gaps[:10])


# --- pass A: host times from the spans' own records ---------------------------

def host_table(units):
    """Pass A's table from one drained record a unit (a chunk or a step):
    for each span name, the median over units of its summed host ms in the
    unit and its instances there; ``covered``, the share of the span's host
    time that its direct children hold, over every unit; and the median unit
    of each counter."""
    per, own, kids, counts = {}, {}, {}, {}
    for rec in units:
        spans = rec['spans']
        sums = {}
        for s in spans:
            ms = (s['end_ns'] - s['start_ns']) * 1e-6
            row = sums.setdefault(s['name'], [0., 0])
            row[0] += ms
            row[1] += 1
            own[s['name']] = own.get(s['name'], 0.) + ms
            if s['parent'] is not None:
                p = spans[s['parent']]['name']
                kids[p] = kids.get(p, 0.) + ms
        for name, (ms, n) in sums.items():
            per.setdefault(name, []).append((ms, n))
        for name, v in rec['counts'].items():
            counts.setdefault(name, []).append(v)
    table = {name: dict(host_ms=statistics.median(v[0] for v in rows),
                        n=statistics.median(v[1] for v in rows),
                        covered=kids.get(name, 0.) / own[name] if own[name] else None)
             for name, rows in per.items()}
    return dict(spans=table, counts={k: statistics.median(v) for k, v in counts.items()},
                counts_each=counts, units=len(units))


def set_up_table(records):
    """Each set-up span's summed seconds."""
    out = {}
    for s in records['spans']:
        out[s['name']] = out.get(s['name'], 0.) + (s['end_ns'] - s['start_ns']) * 1e-9
    return out


# --- the passes -----------------------------------------------------------------

def pass_a(unit, n, sync):
    """``n`` calls of ``unit`` with the spans on, drained after each: the
    records and each call's wall seconds (a chunk syncs itself, a step does
    not), the wall seconds of all (``sync`` ends them), and what each call
    returned."""
    from megastep_tpu_torch import tracing
    records, walls, results = [], [], []
    tracing.enable()
    try:
        t_all = time.perf_counter()
        for _ in range(n):
            t = time.perf_counter()
            results.append(unit())
            walls.append(time.perf_counter() - t)
            records.append(tracing.drain())
        sync()
        total = time.perf_counter() - t_all
    finally:
        tracing.disable()
        tracing.drain()
    return records, walls, total, results


def pass_b(fn, device):
    """``fn`` with the spans on under ``torch.profiler`` (CPU and, on a card,
    CUDA activity), the device synced inside: the trace's events, the spans'
    records, and the wall seconds of ``fn`` and the sync."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from megastep_tpu_torch import tracing
    cuda = device == 'cuda'
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    tracing.enable()
    try:
        with profile(activities=activities) as prof:
            t = time.perf_counter()
            fn()
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t
        records = tracing.drain()
    finally:
        tracing.disable()
        tracing.drain()
    path = Path(os.environ.get('TMPDIR', '/tmp')) / f'benchmark-spans-{os.getpid()}.json'
    try:
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())['traceEvents']
    finally:
        path.unlink(missing_ok=True)
    return events, records, wall


def span_cost(n=100_000):
    """Nanoseconds of one span's entry and exit on this host, off and on
    (no profiler), each the median of five timings of ``n`` spans."""
    from megastep_tpu_torch import tracing

    def timed():
        t = time.perf_counter_ns()
        for _ in range(n):
            with tracing.span('x'):
                pass
        t = (time.perf_counter_ns() - t) / n
        tracing.drain()
        return t
    off = statistics.median(timed() for _ in range(5))
    tracing.enable()
    try:
        on = statistics.median([timed() for _ in range(5)])
    finally:
        tracing.disable()
    return dict(off_ns=off, on_ns=on)


def run_cell(c, seed, device='cuda', window=5, t_start=None):
    """Builds cell ``c`` and runs the untraced window (``window`` chunks, or
    blocks of steps) and both passes: the table."""
    import torch
    from megastep_tpu_torch import tracing
    from benchmark.drivers import step as step_driver
    from benchmark.drivers import train as train_driver
    t_start = common.now() if t_start is None else t_start
    cuda = device == 'cuda'
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    kind = c['traffic']['driver']
    t_build = common.now()
    tracing.enable()
    try:
        if kind == 'train':
            proxy, agent, opt, gen, carry, step = train_driver.build(c, seed, device)
            state = dict(carry=carry)

            def unit():
                state['carry'], metrics = step(state['carry'], gen)
                return metrics['minibatches']
            warm, per_unit, pass_n = c['traffic']['checked_chunks'], 1, 3
        else:
            env, gen, keep = step_driver.build(c, seed, device)
            loop = step_driver.Loop(env, gen, keep, c['traffic']['kept_steps'],
                                    c['config']['n_agents'])
            unit = loop.step
            warm = max(step_driver.WARMUP_STEPS, c['traffic']['kept_steps'] + 2)
            per_unit, pass_n = step_driver.TRACED_STEPS, step_driver.TRACED_STEPS
        sync()
    finally:
        tracing.disable()
    setup = tracing.drain()
    t_warm = common.now()
    for _ in range(warm):
        unit()
    sync()
    setup_s = common.now() - t_start
    # Set-up in three parts: before the build (imports, the CUDA context), the
    # build (the set-up spans, the plans, the agent, the reset), the warm-up
    # (in a run, the checked chunks).
    setup_parts = dict(before_build_s=t_build - t_start, build_s=t_warm - t_build,
                       warm_up_s=setup_s - (t_warm - t_start))

    # The window, tracing off: per unit of per_unit calls, each synced.
    off = []
    for _ in range(window):
        t = time.perf_counter()
        for _ in range(per_unit):
            unit()
        sync()
        off.append((time.perf_counter() - t) / per_unit)
    records, walls, total, results = pass_a(unit, pass_n, sync)
    on = walls if kind == 'train' else [total / pass_n]
    events, b_records, b_wall = pass_b(lambda: [unit() for _ in range(per_unit)], device)
    b_wall /= per_unit
    names = {s['name'] for s in b_records['spans']}
    b = attribute(events, names)
    # Every span recorded stands in the trace as an annotation: the two counts.
    b['spans_recorded'] = {k: sum(1 for s in b_records['spans'] if s['name'] == k)
                           for k in names}
    b['annotations'] = {k: row['n'] for k, row in b['spans'].items() if k != OUTSIDE}
    out = dict(cell=c['name'], seed=seed, setup_s=setup_s, setup_parts=setup_parts,
               setup_spans=set_up_table(setup), span_cost=span_cost(),
               off_ms=[1e3 * x for x in off], on_ms=[1e3 * x for x in on],
               pass_b_wall_ms=1e3 * b_wall, unit=('chunk' if kind == 'train' else 'step'),
               pass_a=host_table(records), pass_b=b, pass_b_units=per_unit)
    if kind == 'train':
        out['minibatches'] = results
    return out


def main(argv=None):
    t_start = common.now()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('spans: needs a CUDA device', file=sys.stderr)
        return 2
    c = common.cell(args.workload)
    torch.zeros(1, device='cuda')  # the CUDA context, made before the build as in a run
    out = run_cell(c, args.seed, 'cuda', t_start=t_start)
    out['device'] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
