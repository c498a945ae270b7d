"""Procedural multi-room floorplans.

An offline-friendly geometry source with the same statistical role as the cubicasa
dataset (``megastep/cubicasa.py``): varied multi-room layouts with
door openings, room polygons, centroid lights, and occupancy masks. Generated by
recursive binary space partitioning, pure numpy, no downloads — the default geometry
source for the demo envs when the cubicasa cache is absent (see
:func:`megastep_tpu_torch.cubicasa.sample`). A copy of :mod:`megastep_tpu.floorplans`:
the same seed gives the same floorplans in both packages.
"""
import numpy as np

from . import geometry
from .dotdict import dotdict

DOOR_WIDTH = .9
MIN_ROOM = 2.5


def _split(lo, hi, random):
    """Random split point that leaves at least MIN_ROOM on either side."""
    return random.uniform(lo + MIN_ROOM, hi - MIN_ROOM)


def _partition(rect, random, depth=0, max_depth=4, stop=.15):
    """Recursively splits (l, b, r, t) into rooms; returns (rooms, walls) where walls
    are internal partitions with a door gap left in each."""
    l, b, r, t = rect
    w, h = r - l, t - b
    can_v = w > 2 * MIN_ROOM
    can_h = h > 2 * MIN_ROOM
    if depth >= max_depth or (not can_v and not can_h) or random.uniform() < stop * depth:
        return [rect], []

    vertical = can_v and (not can_h or (w > h) or random.uniform() < .5)
    if vertical:
        x = _split(l, r, random)
        gap0 = random.uniform(b + .2, t - .2 - DOOR_WIDTH)
        wall = [((x, b), (x, gap0)), ((x, gap0 + DOOR_WIDTH), (x, t))]
        rects = [(l, b, x, t), (x, b, r, t)]
    else:
        y = _split(b, t, random)
        gap0 = random.uniform(l + .2, r - .2 - DOOR_WIDTH)
        wall = [((l, y), (gap0, y)), ((gap0 + DOOR_WIDTH, y), (r, y))]
        rects = [(l, b, r, y), (l, y, r, t)]

    rooms, walls = [], [seg for seg in wall if _length(seg) > 1e-3]
    for sub in rects:
        rs, ws = _partition(sub, random, depth + 1, max_depth, stop)
        rooms += rs
        walls += ws
    return rooms, walls


def _length(seg):
    (x0, y0), (x1, y1) = seg
    return ((x1 - x0)**2 + (y1 - y0)**2)**.5


def one(width=None, height=None, random=None, max_depth=4, stop=.15):
    """Generates a single floorplan geometry.

    :param width/height: outer extents in meters; random in [6, 14] by default.
    :param random: a ``np.random.RandomState``.
    :param stop: early-stop probability factor per depth (lower -> more rooms).
    :return: a geometry dotdict (id, walls, lights, masks, res) — the same schema as
        :func:`megastep_tpu_torch.toys.box` and the cubicasa geometries.
    """
    random = np.random if random is None else random
    width = random.uniform(6., 14.) if width is None else width
    height = random.uniform(6., 14.) if height is None else height

    m = geometry.MARGIN
    outer = (m, m, m + width, m + height)
    rooms, walls = _partition(outer, random, max_depth=max_depth, stop=stop)

    l, b, r, t = outer
    boundary = [((l, b), (r, b)), ((r, b), (r, t)), ((r, t), (l, t)), ((l, t), (l, b))]
    walls = np.array(boundary + walls)

    spaces = [np.array([(rl, rb), (rr, rb), (rr, rt), (rl, rt)])
              for (rl, rb, rr, rt) in rooms]
    lights = geometry.centroids(spaces)

    return dotdict(
        id=f'procedural/{len(rooms)}rooms',
        walls=walls,
        lights=lights,
        masks=geometry.masks(walls, spaces),
        res=geometry.RES)


def sample(n, seed=1, **kwargs):
    """Generates ``n`` floorplan geometries with a fixed seed (deterministic, like
    the cubicasa split sampler, ``cubicasa.py:177-224``)."""
    random = np.random.RandomState(seed)
    return [one(random=random, **kwargs) for _ in range(n)]
