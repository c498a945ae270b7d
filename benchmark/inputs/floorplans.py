"""Procedural multi-room floorplans: the benchmark's frozen copy of the port's
generator (``megastep_tpu_torch/floorplans.py`` and the parts of
``megastep_tpu_torch/geometry.py`` it calls), in numpy alone.

The same seed gives the same plans as ``megastep_tpu_torch.floorplans.sample``
(``benchmark/tests/test_bench_inputs.py`` holds the two together). A plan is a
:class:`Plan`: ``walls`` (n, 2, 2) and ``lights`` (k, 2) in meters, the
occupancy ``masks`` (H, W) int16 (rooms 1, 2, ..., free 0, walls -1) and the
mask's ``res`` in meters a cell.
"""
import numpy as np

MARGIN = 1.
RES = .2
DOOR_WIDTH = .9
MIN_ROOM = 2.5


class Plan(dict):
    """A dict whose keys read as attributes too, as the port's geometries do."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None


def _point_in_polygon(points, poly):
    points, poly = np.asarray(points, dtype=float), np.asarray(poly, dtype=float)
    x, y = points[..., 0, None], points[..., 1, None]
    x0, y0 = poly[:, 0], poly[:, 1]
    x1, y1 = np.roll(poly[:, 0], -1), np.roll(poly[:, 1], -1)
    straddles = (y0 <= y) != (y1 <= y)
    with np.errstate(divide='ignore', invalid='ignore'):
        xs = x0 + (y - y0) / (y1 - y0) * (x1 - x0)
    return (straddles & (xs > x)).sum(-1) % 2 == 1


def _segment_point_distance(a, b, points):
    a, b, points = (np.asarray(v, dtype=float) for v in (a, b, points))
    d = b - a
    t = np.clip(((points - a) * d).sum(-1) / np.maximum((d**2).sum(-1), 1e-12), 0., 1.)
    return np.sqrt(((points - (a + t[..., None] * d))**2).sum(-1))


def _grid_shape(points):
    assert points.min() > 0
    r, t = points.max(0) + MARGIN
    return int(t / RES) + 1, int(r / RES) + 1


def _cell_centers(shape, res=RES):
    h, w = shape
    i = np.arange(h)[:, None] + .5
    j = np.arange(w)[None, :] + .5
    return np.stack([res * np.broadcast_to(j, (h, w)),
                     res * (h - np.broadcast_to(i, (h, w)))], -1)


def masks(walls, spaces, res=RES):
    """Rooms painted ``i + 1`` where the cell center is inside room ``i``, then
    walls painted -1 wherever a wall passes within half a cell plus 1 cm."""
    walls = np.asarray(walls, dtype=float)
    shape = _grid_shape(np.concatenate([walls.reshape(-1, 2)]
                                       + [np.asarray(s).reshape(-1, 2) for s in spaces]))
    centers = _cell_centers(shape, res)
    out = np.zeros(shape, dtype=np.int16)
    for i, poly in enumerate(spaces):
        out[_point_in_polygon(centers, np.asarray(poly))] = i + 1
    threshold = .01 + res / 2
    h, w = shape
    for a, b in walls:
        lo = np.minimum(a, b) - threshold - res
        hi = np.maximum(a, b) + threshold + res
        j0, j1 = max(int(lo[0] / res), 0), min(int(np.ceil(hi[0] / res)) + 1, w)
        i0 = max(int(h - hi[1] / res) - 1, 0)
        i1 = min(int(np.ceil(h - lo[1] / res)) + 1, h)
        d = _segment_point_distance(a, b, centers[i0:i1, j0:j1])
        out[i0:i1, j0:j1][d <= threshold] = -1
    return out


def centroids(spaces):
    """Area centroid of each polygon, (n, 2)."""
    out = []
    for ps in spaces:
        ps = np.asarray(ps, dtype=float)
        x0, y0 = ps[:, 0], ps[:, 1]
        x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
        cross = x0 * y1 - x1 * y0
        a = cross.sum() / 2
        if abs(a) < 1e-12:
            out.append(ps.mean(0))
        else:
            out.append(np.array([((x0 + x1) * cross).sum() / (6 * a),
                                 ((y0 + y1) * cross).sum() / (6 * a)]))
    return np.array(out).reshape(-1, 2)


def _length(seg):
    (x0, y0), (x1, y1) = seg
    return ((x1 - x0)**2 + (y1 - y0)**2)**.5


def _partition(rect, random, depth=0, max_depth=4, stop=.15):
    l, b, r, t = rect
    w, h = r - l, t - b
    can_v, can_h = w > 2 * MIN_ROOM, h > 2 * MIN_ROOM
    if depth >= max_depth or (not can_v and not can_h) or random.uniform() < stop * depth:
        return [rect], []
    vertical = can_v and (not can_h or (w > h) or random.uniform() < .5)
    if vertical:
        x = random.uniform(l + MIN_ROOM, r - MIN_ROOM)
        gap0 = random.uniform(b + .2, t - .2 - DOOR_WIDTH)
        wall = [((x, b), (x, gap0)), ((x, gap0 + DOOR_WIDTH), (x, t))]
        rects = [(l, b, x, t), (x, b, r, t)]
    else:
        y = random.uniform(b + MIN_ROOM, t - MIN_ROOM)
        gap0 = random.uniform(l + .2, r - .2 - DOOR_WIDTH)
        wall = [((l, y), (gap0, y)), ((gap0 + DOOR_WIDTH, y), (r, y))]
        rects = [(l, b, r, y), (l, y, r, t)]
    rooms, walls = [], [seg for seg in wall if _length(seg) > 1e-3]
    for sub in rects:
        rs, ws = _partition(sub, random, depth + 1, max_depth, stop)
        rooms += rs
        walls += ws
    return rooms, walls


def one(random, max_depth=4, stop=.15):
    """One floorplan, 6-14 m a side, split into rooms with a door in each wall."""
    width, height = random.uniform(6., 14.), random.uniform(6., 14.)
    m = MARGIN
    outer = (m, m, m + width, m + height)
    rooms, walls = _partition(outer, random, max_depth=max_depth, stop=stop)
    l, b, r, t = outer
    boundary = [((l, b), (r, b)), ((r, b), (r, t)), ((r, t), (l, t)), ((l, t), (l, b))]
    walls = np.array(boundary + walls)
    spaces = [np.array([(rl, rb), (rr, rb), (rr, rt), (rl, rt)])
              for (rl, rb, rr, rt) in rooms]
    return Plan(id=f'procedural/{len(rooms)}rooms', walls=walls,
                lights=centroids(spaces), masks=masks(walls, spaces), res=RES)


def sample(n, seed):
    """``n`` floorplans from ``np.random.RandomState(seed)``."""
    random = np.random.RandomState(seed)
    return [one(random) for _ in range(n)]


def tiled(plans, n):
    """``n`` scenes' plans: ``plans`` repeated in order."""
    return [plans[i % len(plans)] for i in range(n)]


def arranged(n_plans, plan_seed, n, seed):
    """``n`` scenes' plans: the ``n_plans`` plans of ``plan_seed`` tiled,
    in an order drawn from ``seed``. Every seed gets the same plans, and so
    the same padded sizes and work, in another order."""
    plans = tiled(sample(n_plans, plan_seed), n)
    return [plans[i] for i in np.random.RandomState(seed).permutation(n)]
