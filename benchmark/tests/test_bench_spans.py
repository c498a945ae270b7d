"""The program's spans read against a trace (``benchmark/spans.py``) and the
launch readers, on synthetic records, and the spans script's path on a
small cell on the CPU."""
import numpy as np
import pytest

from benchmark import common, spans


def _host_trace(rows, span=(0., 100.)):
    return dict(span=span, device=None,
                host=dict(name=np.array([r[0] for r in rows], dtype=object),
                          ts=np.array([r[1] for r in rows], dtype=float),
                          dur=np.array([r[2] for r in rows], dtype=float)))


def test_launch_readers_count_launch_calls_inside_the_window():
    rows = [('cudaLaunchKernel', 1, 1), ('aten::add', 2, 5), ('cudaLaunchKernel', 3, 1),
            ('cuLaunchKernel', 40, 1), ('cudaLaunchKernelExC', 50, 1),
            ('cudaMemcpyAsync', 60, 1), ('cudaLaunchKernel', 99, 1),
            ('cudaLaunchKernel', 150, 1)]  # after the window
    rec = dict(host_trace=_host_trace(rows))
    # Five launches in the window, two of them the marker fills.
    assert common.reader('launches.train').read(rec) == 3
    from benchmark.drivers.step import TRACED_STEPS
    assert common.reader('launches.step').read(rec) == pytest.approx(3 / TRACED_STEPS)
    for name in ('launches.train', 'launches.step'):
        assert common.reader(name).read({}) is None
        assert common.reader(name).read(dict(host_trace=None)) is None


def _x(cat, name, ts, dur, tid=1, **args):
    return dict(ph='X', cat=cat, name=name, ts=ts, dur=dur, pid=1, tid=tid, args=args)


def _events():
    """``a`` [0, 100) holding ``b`` [10, 50); ``c`` [120, 130) alone."""
    return [
        _x('user_annotation', 'a', 0, 100), _x('user_annotation', 'b', 10, 40),
        _x('user_annotation', 'c', 120, 10),
        _x('user_annotation', 'benchmark.traced_window', -5, 200),  # not a program span
        # Launched inside b, run long after the span closed: b's by correlation.
        _x('cuda_runtime', 'cudaLaunchKernel', 20, 2, correlation=1),
        _x('kernel', 'k1', 200, 30, tid=7, correlation=1),
        # Launched inside a, after b: a's own.
        _x('cuda_runtime', 'cudaLaunchKernel', 60, 2, correlation=2),
        _x('kernel', 'k2', 62, 8, tid=7, correlation=2),
        # From another thread (autograd's), inside b's interval: b's.
        _x('cuda_driver', 'cuLaunchKernel', 30, 1, tid=2, correlation=3),
        _x('kernel', 'k3', 70, 5, tid=7, correlation=3),
        # Outside every span: the benchmark's own draw.
        _x('cuda_runtime', 'cudaLaunchKernel', 110, 1, correlation=4),
        _x('kernel', 'randint', 111, 4, tid=7, correlation=4),
        # A copy inside c; it launches nothing.
        _x('cuda_runtime', 'cudaMemcpyAsync', 125, 1, correlation=5),
        _x('gpu_memcpy', 'Memcpy DtoH', 126, 2, tid=7, correlation=5),
        # A device op with no launching call in the trace.
        _x('kernel', 'orphan', 240, 1, tid=7, correlation=99),
    ]


def test_device_time_goes_to_the_span_of_its_launch_by_correlation():
    t = spans.attribute(_events(), {'a', 'b', 'c'})
    a, b, c, out = (t['spans'][k] for k in ('a', 'b', 'c', spans.OUTSIDE))
    assert b['device_ms'] == pytest.approx(.035) and b['device_self_ms'] == pytest.approx(.035)
    assert a['device_ms'] == pytest.approx(.043) and a['device_self_ms'] == pytest.approx(.008)
    assert c['device_ms'] == pytest.approx(.002)
    assert out['device_ms'] == pytest.approx(.004) and out['device_ops'][0][0] == 'randint'
    assert t['unmatched_device_ms'] == pytest.approx(.001)
    assert {k: t['spans'][k]['n'] for k in 'abc'} == {'a': 1, 'b': 1, 'c': 1}


def test_a_launch_from_another_thread_goes_to_the_span_open_at_its_time():
    t = spans.attribute(_events(), {'a', 'b', 'c'})
    b, a = t['spans']['b'], t['spans']['a']
    assert b['launches'] == 2 and b['launches_self'] == 2  # tid 1 at 20, tid 2 at 30
    assert a['launches'] == 3 and a['launches_self'] == 1
    assert t['spans'][spans.OUTSIDE]['launches'] == 1
    assert t['launches'] == 4 and t['kernels'] == 5


def test_every_idle_stretch_goes_under_the_span_open_then():
    t = spans.attribute(_events(), {'a', 'b', 'c'})
    # The window: from a's start (0) to the last device op's end (241). Busy:
    # [62, 70), [70, 75), [111, 115), [126, 128), [200, 230), [240, 241).
    # Idle under b [10, 50): all 40 us; under a alone: [0, 10), [50, 62),
    # [75, 100); under c: [120, 126), [128, 130); outside: the rest.
    s = t['spans']
    assert s['b']['idle_self_ms'] == pytest.approx(.040)
    assert s['a']['idle_self_ms'] == pytest.approx(.047)
    assert s['a']['idle_ms'] == pytest.approx(.087)
    assert s['c']['idle_ms'] == pytest.approx(.008)
    assert s[spans.OUTSIDE]['idle_ms'] == pytest.approx(.096)
    # The longest: [128, 200), mostly outside; then [0, 62), mostly b's.
    assert t['longest_idle'][:2] == [[spans.OUTSIDE, pytest.approx(.072)],
                                     ['b', pytest.approx(.062)]]


def test_host_table_takes_medians_and_coverage_from_drained_records():
    def unit(scale, syncs):
        ns = lambda ms: int(ms * 1e6 * scale)
        return dict(spans=[
            dict(name='train.chunk', parent=None, start_ns=0, end_ns=ns(100)),
            dict(name='train.rollout', parent=0, start_ns=ns(1), end_ns=ns(31)),
            dict(name='train.learn', parent=0, start_ns=ns(31), end_ns=ns(91)),
            dict(name='learn.backward', parent=2, start_ns=ns(40), end_ns=ns(70)),
            dict(name='learn.backward', parent=2, start_ns=ns(70), end_ns=ns(80))],
            counts=dict(host_syncs=syncs))
    t = spans.host_table([unit(1., 17), unit(2., 17), unit(3., 9)])
    s = t['spans']
    assert s['train.chunk']['host_ms'] == pytest.approx(200)
    assert s['train.chunk']['covered'] == pytest.approx(.9)
    assert s['train.learn']['covered'] == pytest.approx(40 / 60)
    assert s['learn.backward']['host_ms'] == pytest.approx(80) and s['learn.backward']['n'] == 2
    assert s['learn.backward']['covered'] == 0
    assert t['counts'] == {'host_syncs': 17} and t['counts_each'] == {'host_syncs': [17, 17, 9]}


def test_the_spans_script_path_on_small_cells_on_the_cpu(tiny):
    train = spans.run_cell(tiny('explorer-train', checked_chunks=1), 2**31 + 11, 'cpu', window=1)
    a, b = train['pass_a'], train['pass_b']
    assert a['units'] == 3 and train['unit'] == 'chunk'
    assert a['counts_each']['host_syncs'] == [m + 1 for m in train['minibatches']]
    assert a['spans']['rollout.agent']['n'] == 4 and a['spans']['env.step']['n'] == 4
    assert set(train['setup_spans']) == {'scene.scenery', 'spawns.tables'}
    # Every span recorded in pass B stands in its trace as an annotation.
    assert b['annotations'] == b['spans_recorded']
    step = spans.run_cell(tiny('deathmatch-step'), 2**31 + 12, 'cpu', window=1)
    assert step['unit'] == 'step' and step['pass_b']['spans_recorded'] == {
        'env.step': 48, 'env.rebake': 48} == step['pass_b']['annotations']
    assert step['pass_a']['spans']['env.rebake']['n'] == 1
