"""The frozen floorplan generator gives the port's plans at the same seed."""
import numpy as np
import pytest

from benchmark.inputs import floorplans


@pytest.mark.parametrize('seed', [1, 2**31 + 7])
def test_plans_equal_the_ports(seed):
    from megastep_tpu_torch import floorplans as port
    s = seed % 2**32
    ours, theirs = floorplans.sample(6, s), port.sample(6, seed=s)
    for a, b in zip(ours, theirs):
        assert a['id'] == b['id'] and a.res == b.res
        for k in ('walls', 'lights', 'masks'):
            np.testing.assert_array_equal(a[k], b[k])
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype


def test_plans_come_from_their_seed():
    a, b = floorplans.sample(2, 5), floorplans.sample(2, 6)
    assert not np.array_equal(a[0]['walls'], b[0]['walls']) or \
        not np.array_equal(a[1]['walls'], b[1]['walls'])
    assert floorplans.tiled(a, 5) == [a[0], a[1], a[0], a[1], a[0]]


def test_every_seed_gets_the_same_plans_in_another_order():
    a, b = floorplans.arranged(4, 1, 10, 5), floorplans.arranged(4, 1, 10, 6)
    key = lambda p: p['walls'].tobytes()
    assert sorted(map(key, a)) == sorted(map(key, b))
    assert list(map(key, a)) != list(map(key, b))
    assert list(map(key, a)) == list(map(key, floorplans.arranged(4, 1, 10, 5)))
