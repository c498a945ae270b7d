"""The port's polygon booleans (``megastep_tpu_torch.polygons``) against the JAX
package's (``megastep_tpu.polygons``), on every input of ``tests/test_polygons.py``
with the same seeds. Both are numpy in float64, so the outputs must be equal,
array for array (tolerance: none).
"""
import numpy as np
import pytest
import torch

from megastep_tpu_torch import polygons

torch.set_num_threads(1)

SQUARE = [[0, 0], [10, 0], [10, 10], [0, 10]]


def _rect(rng, rotated):
    c = rng.uniform(0, 10, 2)
    w, h = rng.uniform(.8, 4, 2)
    pts = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
    if rotated:
        a = rng.uniform(0, np.pi)
        R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        pts = pts @ R.T
    return pts + c


def _soup(seed):
    """``test_random_rect_soup_vs_raster_oracle``'s solids and cuts."""
    rng = np.random.RandomState(seed)
    solids = [_rect(rng, i % 2) for i in range(4)]
    cuts = [_rect(rng, 0) * .5 for _ in range(2)]
    return solids, cuts


def _floorplan(seed, dilate):
    """``test_floorplan_scale_soup_vs_raster_oracle``'s plan, its door cuts
    dilated by ``dilate`` (the JAX or the port's ``dilate_convex``)."""
    rng = np.random.RandomState(100 + seed)
    t = .2
    W, H = rng.uniform(8, 14), rng.uniform(6, 10)

    def hwall(x0, x1, y):
        return np.array([[x0, y], [x1, y], [x1, y + t], [x0, y + t]])

    def vwall(x, y0, y1):
        return np.array([[x, y0], [x + t, y0], [x + t, y1], [x, y1]])

    solids = [hwall(1, 1 + W, 1), hwall(1, 1 + W, 1 + H - t),
              vwall(1, 1, 1 + H), vwall(1 + W - t, 1, 1 + H)]
    vxs = np.sort(rng.uniform(2.5, W - .5, rng.randint(3, 6))) + 1
    hys = np.sort(rng.uniform(2, H - .5, rng.randint(2, 4))) + 1
    cuts = []
    for x in vxs:
        solids.append(vwall(x, 1 + t, 1 + H - t))
        y = rng.uniform(1.5, H - .5) + 1
        cuts.append(vwall(x, y, y + .9))
    for y in hys:
        solids.append(hwall(1 + t, 1 + W - t, y))
        x = rng.uniform(1.5, W - 1.5) + 1
        cuts.append(hwall(x, x + .9, y))
    for _ in range(rng.randint(2, 5)):
        c = rng.uniform(2.5, min(W, H) - .5, 2) + 1
        s = rng.uniform(.3, .7)
        solids.append(np.array([[0, 0], [s, 0], [s, s], [0, s]]) + c)
    for _ in range(2):
        c = rng.uniform(3, min(W, H) - 1, 2) + 1
        a = rng.uniform(0, np.pi)
        R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        pts = np.array([[-1.2, -t], [1.2, -t], [1.2, t], [-1.2, t]]) / 2
        solids.append(pts @ R.T + c)
    return solids, [dilate(c, .05) for c in cuts]


def _rotated():
    c, s = np.cos(.3), np.sin(.3)
    return np.array(SQUARE, float) @ np.array([[c, -s], [s, c]]).T


#: Each case of tests/test_polygons.py as (solids, cuts) of boundary_segments.
BOOLEANS = {
    'single_square': lambda: ([SQUARE], []),
    'union_removes_seam': lambda: ([[[0, 0], [10, 0], [10, 5], [0, 5]],
                                    [[5, 0], [15, 0], [15, 5], [5, 5]]], []),
    'difference_notch': lambda: ([SQUARE], [np.array([[4, -1], [6, -1], [6, 1], [4, 1]],
                                                     float)]),
    'hole_ring_kept': lambda: ([[[0, 0], [20, 0], [20, 20], [0, 20]]],
                               [np.array([[5, 5], [15, 5], [15, 15], [5, 15]], float)]),
    'cut_outside_solid_is_noop': lambda: ([SQUARE], [np.array(
        [[50, 50], [60, 50], [60, 60], [50, 60]], float)]),
    'orientation_insensitive_inputs': lambda: ([[[0, 0], [0, 10], [10, 10], [10, 0]]], []),
    'rotated_polygons': lambda: ([_rotated()], []),
    **{f'random_rect_soup_{seed}': (lambda seed=seed: _soup(seed)) for seed in range(5)},
}


@pytest.fixture(scope='module')
def jpolygons():
    return pytest.importorskip('megastep_tpu.polygons')


def _equal(ours, theirs):
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize('case', sorted(BOOLEANS))
def test_boundary_segments_match_jax(jpolygons, case):
    solids, cuts = BOOLEANS[case]()
    segs = polygons.boundary_segments(solids, cuts)
    assert len(segs)
    _equal(segs, jpolygons.boundary_segments(solids, cuts))
    # The containment test the booleans sample with, at the segments' midpoints
    # pushed off to either side, polygon by polygon.
    mid = segs.mean(1)
    t = segs[:, 1] - segs[:, 0]
    n = np.stack([-t[:, 1], t[:, 0]], 1) / np.linalg.norm(t, axis=1, keepdims=True)
    for p in list(solids) + list(cuts):
        for pts in (mid + 1e-6 * n, mid - 1e-6 * n):
            _equal(polygons.points_in_polygon(pts, np.asarray(p, float)),
                   jpolygons.points_in_polygon(pts, np.asarray(p, float)))


@pytest.mark.parametrize('seed', range(3))
def test_floorplan_scale_soup_matches_jax(jpolygons, seed):
    solids, cuts = _floorplan(seed, polygons.dilate_convex)
    jsolids, jcuts = _floorplan(seed, jpolygons.dilate_convex)
    for c, jc in zip(cuts, jcuts):
        _equal(c, jc)
    assert len(solids) >= 15 and len(cuts) >= 5
    _equal(polygons.boundary_segments(solids, cuts),
           jpolygons.boundary_segments(jsolids, jcuts))


def test_dilate_convex_matches_jax(jpolygons):
    rect = np.array([[0, 0], [10, 0], [10, 4], [0, 4.]])
    fat = polygons.dilate_convex(rect, 1.)
    _equal(fat, jpolygons.dilate_convex(rect, 1.))
    np.testing.assert_allclose(fat.min(0), [-1, -1])
    np.testing.assert_allclose(fat.max(0), [11, 5])
    # A non-convex input is replaced by its hull in both.
    dent = np.array([[0, 0], [4, 0], [2, 1], [4, 4], [0, 4.]])
    _equal(polygons.dilate_convex(dent, .5), jpolygons.dilate_convex(dent, .5))


def test_points_in_polygon_matches_jax(jpolygons):
    tri = np.array([[0, 0], [4, 0], [0, 4.]])
    pts = np.array([[1, 1], [3, 3], [-1, 0], [2, 1.5]])
    inside = polygons.points_in_polygon(pts, tri)
    np.testing.assert_array_equal(inside, [True, False, False, True])
    _equal(inside, jpolygons.points_in_polygon(pts, tri))
