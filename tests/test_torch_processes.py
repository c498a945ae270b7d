"""The port's ``rebar.queuing`` and ``rebar.processes`` against the JAX
package's, on the CPU.

Both packages' serial queues, sentinels and single-process ``consensus`` run
the same scripts, and their outcomes must be equal. One spawned child runs the
END protocol with this process over ``MultiprocessQueue``s; its join has a
time limit.
"""
import asyncio
import multiprocessing as mp
import time

import pytest
import torch

from megastep_tpu_torch.rebar import processes, queuing

torch.set_num_threads(1)

JOIN_S = 120


@pytest.fixture(scope='module')
def jrebar():
    pytest.importorskip('megastep_tpu.rebar.processes')
    from megastep_tpu.rebar import processes as jprocesses, queuing as jqueuing
    return jqueuing, jprocesses


def _script(q):
    """A scripted sequence of puts, gets, ENDs and joins on one serial queue;
    each outcome, or the error it raised."""
    ops = [('put', 1), ('put', 2), ('join',), ('get',), ('get',), ('join',),
           ('put', None), ('put', queuing.END), ('put', {'x': 3}), ('put_end',),
           ('get',), ('put_end',), ('get_end',), ('put', 'after'), ('get_end',),
           ('get',), ('put_end',)]
    out = []
    for name, *args in ops:
        try:
            out.append((name, getattr(q, name)(*args)))
        except ValueError as e:
            out.append((name, 'ValueError', str(e)))
    return out


def test_serial_queue_script_matches_jax(jrebar):
    jqueuing, _ = jrebar
    got, want = _script(queuing.SerialQueue()), _script(jqueuing.SerialQueue())
    assert got == want
    assert ('put', 'ValueError', 'Tried to put sentinel value "__END__"') in got
    assert ('get_end', True) in got


def _close(queuing):
    """``close`` while the peer's queues start out full (reference
    ``queuing.py:122-169``; ``tests/test_rebar_extra.py:65-93``): the outcome of
    each of the peer's moves and of the final checks."""
    up, down = queuing.SerialQueue(), queuing.SerialQueue()
    trace = [down.put('stuck-item'), up.put('unread-item')]

    async def peer():
        await asyncio.sleep(0)
        trace.append(down.get())
        for i in range(100):
            if up.put_end() and down.get_end():
                trace.append(('peer done', i > 0))
                return
            await asyncio.sleep(0)
        raise AssertionError('the peer never completed the END exchange')

    async def run():
        await asyncio.gather(queuing.close([up], [down], timeout=5), peer())

    asyncio.run(run())
    return trace + [up.get_end(), down.get_end(), down.join()]


def test_three_phase_close_matches_jax(jrebar):
    jqueuing, _ = jrebar
    got = _close(queuing)
    assert got == _close(jqueuing)
    assert got[-3:] == [True, True, True]


def test_close_times_out_without_a_peer(jrebar, caplog):
    """With nobody draining the output, ``close`` gives up at its deadline in
    both packages, with the same warning."""
    jqueuing, _ = jrebar
    messages = []
    for q in (queuing, jqueuing):
        out = q.SerialQueue()
        out.put('stuck')
        caplog.clear()
        asyncio.run(q.close([], [out], timeout=.2))
        messages.append([r.getMessage() for r in caplog.records if r.levelname == 'WARNING'])
    assert messages[0] == messages[1] == ['Timed out while waiting to send ENDs']


def test_create_and_cleanup_match_jax(jrebar):
    jqueuing, _ = jrebar
    spec = {'actor': ['obs', 'act'], 'learner': 'params'}

    def shape(tree):
        return {k: shape(v) if isinstance(v, dict) else type(v).__name__
                for k, v in tree.items()}
    assert shape(queuing.create(spec, serial=True)) == shape(jqueuing.create(spec, serial=True))
    assert shape(queuing.create(['a', 'b'])) == {'a': 'MultiprocessQueue',
                                                'b': 'MultiprocessQueue'}
    with pytest.raises(ValueError, match="Can't handle"):
        queuing.create(3)

    async def failing(q):
        async with q.cleanup([], []):
            raise KeyError('boom')
    for q in (queuing, jqueuing):
        with pytest.raises(KeyError):
            asyncio.run(failing(q))


def _echo(intake, output, n):
    """The child: doubles ``n`` items from ``intake`` onto ``output``, then
    closes its side."""
    for _ in range(n):
        item = None
        while item is None:
            item = intake.get()
        while not output.put(2 * item):
            pass
    asyncio.run(queuing.close([intake], [output], timeout=30))


def test_multiprocess_queues_round_trip_with_a_spawned_child():
    to_child, from_child = queuing.MultiprocessQueue(), queuing.MultiprocessQueue()
    child = mp.get_context('spawn').Process(target=_echo, args=(to_child, from_child, 5))
    child.start()
    deadline = time.monotonic() + JOIN_S
    try:
        sent, got = list(range(5)), []
        while sent or len(got) < 5:
            assert time.monotonic() < deadline, f'the child answered {got} in {JOIN_S} s'
            if sent and to_child.put(sent[0]):
                sent.pop(0)
            item = from_child.get()
            if item is not None:
                got.append(item)
        asyncio.run(queuing.close([from_child], [to_child], timeout=30))
        child.join(JOIN_S)
        assert not child.is_alive() and child.exitcode == 0
    finally:
        if child.is_alive():
            child.kill()
    assert got == [0, 2, 4, 6, 8]
    assert from_child.get_end()


def _sentinel_runs(processes):
    ticks = []

    def child(canceller):
        while not canceller.is_set():
            ticks.append(1)
            yield

    with processes.sentinel(serial=True) as s:
        assert s.serial
        s.launch(child, s.canceller)
        for _ in range(3):
            s.check()
    return len(ticks) >= 3, s.canceller.is_set()


def _sentinel_death(processes):
    def dying(canceller):
        yield
        raise ValueError('child died')

    with pytest.raises(ValueError, match='child died'):
        with processes.sentinel(serial=True) as s:
            s.launch(dying, s.canceller)
            for _ in range(3):
                s.check()
    return s.canceller.is_set()


def test_serial_sentinel_and_dead_strands_match_jax(jrebar):
    _, jprocesses = jrebar
    assert _sentinel_runs(processes) == _sentinel_runs(jprocesses) == (True, True)
    assert _sentinel_death(processes) == _sentinel_death(jprocesses) is True


def test_consensus_and_cancel_without_a_group(jrebar):
    _, jprocesses = jrebar
    for b in (True, False, 0, 1):
        assert processes.consensus(b) is jprocesses.consensus(b) is bool(b)
    event = mp.get_context('spawn').Event()
    assert processes.cancel(event) is jprocesses.cancel(event) is False
    event.set()
    assert processes.cancel(event) is jprocesses.cancel(event) is True
