"""The harness: cells found by name, the run's refusals, the end-to-end
arithmetic and the reading of a trace."""
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark import common

ROOT = common.ROOT


def test_every_cell_and_metric_is_found_by_name():
    spec = common.benchmark_spec()
    for w in spec['workloads']:
        c = common.cell(w['name'], spec)
        assert common.driver(c).run
        assert c['end_to_end'] and 'setup_s' in c['end_to_end']
        assert c['per_layer'], w['name']
        assert set(c['limits']) >= {'scenery_gap', 'obs_mismatch'} or 'loss_gap' in c['limits']
    for m in spec['per_layer']:
        assert common.reader(m['name']).read({}) is None  # nothing to read: nothing returned


def test_a_new_cell_needs_no_edit(tmp_path, monkeypatch):
    """A configuration, a traffic mix, limits and a per-layer metric added as
    files of their own, and entries in the spec, make a cell the harness runs."""
    here = tmp_path / 'benchmark'
    shutil.copytree(common.HERE, here, ignore=shutil.ignore_patterns('__pycache__'))
    (here / 'configs' / 'minimal.json').write_text(json.dumps({'env': 'Minimal'}))
    (here / 'traffic' / 'step-few.json').write_text(json.dumps({'driver': 'step'}))
    (here / 'limits' / 'minimal-step.json').write_text(json.dumps({'scenery_gap': 0}))
    (here / 'metrics' / 'pixels.step.py').write_text('def read(rec):\n    return rec.get("px")\n')
    spec = common.benchmark_spec()
    spec['configs'].append(dict(name='minimal', file='benchmark/configs/minimal.json'))
    spec['workloads'].append(dict(name='minimal-step', config='minimal', traffic='step-few'))
    spec['end_to_end'][1]['workloads'].append('minimal-step')
    spec['per_layer'].append(dict(name='pixels.step', moves='agent_steps_per_s',
                                  workloads=['minimal-step']))
    monkeypatch.setattr(common, 'HERE', here)
    monkeypatch.setattr(common, 'ROOT', tmp_path)
    c = common.cell('minimal-step', spec)
    assert c['config'] == {'env': 'Minimal'} and c['traffic'] == {'driver': 'step'}
    assert c['limits'] == {'scenery_gap': 0}
    assert [m['name'] for m in c['per_layer']] == ['pixels.step']
    assert common.reader('pixels.step').read({'px': 3}) == 3
    assert c['end_to_end'] == ['agent_steps_per_s', 'setup_s']


def _run(cwd, *args):
    return subprocess.run([sys.executable, 'benchmark/run.py', '--workload', 'deathmatch-step',
                           '--seed', str(2**31 + 5), '--seconds', '1', *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_a_run_without_a_card_fails_and_says_so(card_absent):
    proc = _run(ROOT)
    assert proc.returncode != 0 and proc.stdout == ''
    assert 'CUDA device' in proc.stderr


def test_a_run_in_a_bare_directory_fails(tmp_path):
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(common.HERE, tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ''


@pytest.fixture
def card_absent():
    import torch
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')


def test_forbidden_modules_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'megastep_tpu_torch_like', object())
    assert 'megastep_tpu' not in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'megastep_tpu.scene', object())
    assert 'megastep_tpu' in common.forbidden_modules()


def test_a_cell_built_and_run_loads_no_jax(tmp_path):
    """A whole run of a small train cell on the CPU, in a fresh process."""
    code = f'''
import sys; sys.path.insert(0, {str(ROOT)!r})
from benchmark import common
c = common.cell('explorer-train')
c['config'].update(plans=2, res=64, subsample=1, width=8)
c['traffic'].update(n_envs=4, buffer=2, batch=4, checked_chunks=1)
out = common.driver(c).run(c, 3, 0.1, 0, 'cpu', common.now())
assert out['attempted'] >= 1
print(common.forbidden_modules())
'''
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                          timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == '[]'


def test_step_metrics_on_synthetic_periods():
    periods = [3.] * 990 + [10.] * 10
    m = common.step_metrics(16384, periods, 4., 20.)
    assert m['agent_steps_per_s'] == pytest.approx(16384 * 1000 / 4.)
    assert m['setup_s'] == 20.
    p99 = common.reader('step_ms_p99.step').read({'step_ms_p99': common.percentile(periods, 99)})
    assert p99 == pytest.approx(np.percentile(periods, 99))
    assert 3. < p99 < 10.
    assert common.percentile([1.] * 99 + [50.], 99) == pytest.approx(1. + .01 * 49.)


def test_train_metrics_on_synthetic_chunks():
    m = common.train_metrics(8192 * 32, 21, 30.5, 18.)
    assert m['train_steps_per_s'] == pytest.approx(8192 * 32 * 21 / 30.5)


def _trace(device, host, span=(0., 100.)):
    def arrays(rows):
        return dict(name=np.array([r[0] for r in rows], dtype=object),
                    ts=np.array([r[1] for r in rows], dtype=float),
                    dur=np.array([r[2] for r in rows], dtype=float))
    return dict(span=span, device=arrays(device), host=arrays(host))


def test_idle_is_the_union_of_overlapping_kernels():
    # Busy: [10, 30] (two overlapping kernels), [25, 40] overlapping them,
    # [60, 70], and a kernel running past the window's end at 95.
    device = [('a', 10, 15), ('b', 20, 10), ('c', 25, 15), ('a', 60, 10), ('d', 95, 20)]
    host = [('aten::copy_', 40, 20), ('cudaLaunchKernel', 45, 2), ('python', 0, 100),
            ('aten::sum', 70, 25)]
    tr = _trace(device, host)
    assert common.busy_intervals(tr) == [(10., 40.), (60., 70.), (95., 100.)]
    assert common.busy_share(tr) == pytest.approx(.45)
    assert common.idle_gaps(tr) == [(70., 95.), (40., 60.), (0., 10.)]
    b = common.breakdown(tr, tr)
    assert b['device_ops'][0] == ['a', pytest.approx(25e-6)]
    # Each gap is named by the host op overlapping it most, the shortest
    # among equals.
    assert [g[0] for g in b['idle_gaps']] == ['aten::sum', 'aten::copy_', 'python']
    assert b['idle_gaps'][0][1] == pytest.approx(25e-6)


def test_kernel_ms_matches_by_pattern():
    tr = _trace([('void observe_kernel<false>(...)', 0, 100), ('other', 0, 5),
                 ('void observe_kernel<false>(...)', 200, 300)], [])
    assert common.kernel_ms(tr, 'observe_kernel') == (pytest.approx(.2), 2)
    assert common.kernel_ms(tr, 'absent') == (None, 0)
