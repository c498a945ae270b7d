"""Floorplan geometry: wall arrays, light positions, and occupancy masks.

Counterpart of ``megastep/geometry.py``, rebuilt without the shapely/
rasterio dependencies: the occupancy-mask rasterizer and polygon centroid are
implemented in pure numpy, so procedural geometries (``megastep_tpu_torch.toys``)
work with zero optional deps. A copy of :mod:`megastep_tpu.geometry`; the SVG
floorplan parser is :mod:`megastep_tpu_torch.cubicasa`.

A *geometry* is a dotdict with:
  * ``walls``: (n_walls, 2, 2) float array of wall segment endpoints, in meters.
  * ``lights``: (n_lights, 2) float array of light positions, in meters.
  * ``masks``: (H, W) int16 occupancy array — indices 1, 2, ... for rooms, 0 for
    free space, -1 for walls (reference ``geometry.py:81-93``).
  * ``res``: resolution of the mask, in meters per cell.
"""
from itertools import islice, cycle

import numpy as np

from .constants import MARGIN, MASK_RES
from .dotdict import dotdict

RES = MASK_RES


def cyclic_pairs(xs):
    """Returns pairs ``(xs[i], xs[i+1])``, wrapping the last pair round to the start."""
    ys = islice(cycle(xs), 1, None)
    return list(zip(xs, ys))


def signed_area(points):
    """Twice the signed area of the polygon with the given vertices (shoelace)."""
    area = 0.
    for x, y in cyclic_pairs(list(points)):
        area += x[0] * y[1] - x[1] * y[0]
    return area


def orient(points):
    """Re-orders polygon vertices to counterclockwise orientation."""
    return points if signed_area(points) > 0 else points[::-1]


def unique(walls):
    """Eliminates walls that duplicate earlier walls in either orientation
    (reference ``geometry.py:35-41``)."""
    forward = ((walls[:, None, :, :] - walls[None, :, ::+1, :])**2).sum(-1).sum(-1)**.5
    backward = ((walls[:, None, :, :] - walls[None, :, ::-1, :])**2).sum(-1).sum(-1)**.5
    mask = (forward < 1e-3) | (backward < 1e-3)
    mask[np.triu_indices_from(mask)] = False
    return walls[~mask.any(1)]


def point_in_polygon(points, poly):
    """Vectorized even-odd (crossing number) point-in-polygon test.

    :param points: (..., 2) query points.
    :param poly: (V, 2) polygon vertices.
    :return: (...,) bool array, True for points strictly inside.
    """
    points = np.asarray(points, dtype=float)
    poly = np.asarray(poly, dtype=float)
    x, y = points[..., 0, None], points[..., 1, None]
    x0, y0 = poly[:, 0], poly[:, 1]
    x1, y1 = np.roll(poly[:, 0], -1), np.roll(poly[:, 1], -1)

    # Edge straddles the horizontal ray through y.
    straddles = (y0 <= y) != (y1 <= y)
    # x coordinate where the edge crosses that horizontal line.
    with np.errstate(divide='ignore', invalid='ignore'):
        xs = x0 + (y - y0) / (y1 - y0) * (x1 - x0)
    crossings = (straddles & (xs > x)).sum(-1)
    return crossings % 2 == 1


def segment_point_distance(seg_a, seg_b, points):
    """Distance from each point to the segment (a, b). All args (..., 2), broadcast."""
    seg_a, seg_b, points = (np.asarray(v, dtype=float) for v in (seg_a, seg_b, points))
    d = seg_b - seg_a
    len2 = (d**2).sum(-1)
    t = ((points - seg_a) * d).sum(-1) / np.maximum(len2, 1e-12)
    t = np.clip(t, 0., 1.)
    proj = seg_a + t[..., None] * d
    return np.sqrt(((points - proj)**2).sum(-1))


def _grid_shape(*pointsets):
    points = np.concatenate([np.concatenate(list(ps)) if isinstance(ps, list) else ps.reshape(-1, 2)
                             for ps in pointsets])
    assert points.min() > 0, 'Masker currently requires the points to be in the top-right quadrant'
    r, t = points.max(0) + MARGIN
    h, w = int(t / RES) + 1, int(r / RES) + 1
    return h, w


def cell_centers(shape, res=RES):
    """(H, W, 2) array of world coordinates of each mask cell's center."""
    h, w = shape
    i = np.arange(h)[:, None] + .5
    j = np.arange(w)[None, :] + .5
    x = res * np.broadcast_to(j, (h, w))
    y = res * (h - np.broadcast_to(i, (h, w)))
    return np.stack([x, y], -1)


def masks(walls, spaces, res=RES):
    """Generates an occupancy array from an array of walls and a list of room polygons.

    Pure-numpy replacement for the reference's rasterio-based ``masks()``
    (``geometry.py:81-93``): rooms are painted with index i+1 where the cell center is
    inside the room polygon; walls are painted -1 over the top wherever the wall segment
    (dilated by half a cell) passes; everything else is 0.

    :param walls: (n_walls, 2, 2) wall endpoint array, meters.
    :param spaces: list of (V, 2) room polygons, meters.
    :param res: mask resolution, meters per cell.
    :return: (H, W) int16 array with 1, 2, ... for rooms, 0 for free space, -1 for walls.
    """
    walls = np.asarray(walls, dtype=float)
    shape = _grid_shape([walls.reshape(-1, 2)] + [np.asarray(s) for s in spaces])
    centers = cell_centers(shape, res)

    out = np.zeros(shape, dtype=np.int16)
    for i, poly in enumerate(spaces):
        inside = point_in_polygon(centers, np.asarray(poly))
        out[inside] = i + 1

    if len(walls):
        # A cell counts as wall if the wall passes within half a cell (plus the 1cm
        # dilation the reference applies) of the cell center. Tested per wall on
        # just its bounding-box cell patch — a full (n_walls, H, W) broadcast
        # churns hundreds of MB on big floorplans for the same answer (cells
        # outside the padded bbox are provably beyond the threshold).
        threshold = .01 + res / 2
        h, w = shape
        for a, b in walls:
            lo = np.minimum(a, b) - threshold - res
            hi = np.maximum(a, b) + threshold + res
            j0, j1 = max(int(lo[0] / res), 0), min(int(np.ceil(hi[0] / res)) + 1, w)
            i0 = max(int(h - hi[1] / res) - 1, 0)
            i1 = min(int(np.ceil(h - lo[1] / res)) + 1, h)
            patch = centers[i0:i1, j0:j1]
            d = segment_point_distance(a, b, patch)
            out[i0:i1, j0:j1][d <= threshold] = -1
    return out


def centroids(spaces):
    """Polygon area centroids of each space (pure-numpy version of
    ``geometry.py:95-97``). Shaped (n_spaces, 2) even when empty."""
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
            cx = ((x0 + x1) * cross).sum() / (6 * a)
            cy = ((y0 + y1) * cross).sum() / (6 * a)
            out.append(np.array([cx, cy]))
    return np.array(out).reshape(-1, 2)


def centers(indices, shape, res):
    """Converts mask (i, j) indices to the (x, y) coordinates of the cell centers
    (reference ``geometry.py:110-122``)."""
    i, j = indices[..., 0] + .5, indices[..., 1] + .5
    return res * np.stack([j, shape[0] - i], -1)


def indices(coords, shape, res):
    """Converts (x, y) coordinates to the (i, j) indices of the containing cell
    (reference ``geometry.py:124-137``)."""
    x, y = coords[..., 0], coords[..., 1]
    i = (shape[0] - y / res).clip(0, shape[0] - 1)
    j = (x / res).clip(0, shape[1] - 1)
    return np.stack([i, j], -1).astype(int)


def display(g):
    """Visualizes a geometry with matplotlib. Supports partial geometries that only
    have a subset of id/walls/lights/masks."""
    import matplotlib as mpl
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots()
    ax.set_aspect(1)

    if 'id' in g:
        ax.set_title(g['id'])
    if 'walls' in g:
        lines = mpl.collections.LineCollection(g['walls'], color='k', linewidth=2)
        ax.add_collection(lines)
        ax.autoscale()
    if 'lights' in g:
        for light in g['lights']:
            ax.add_patch(mpl.patches.Circle(light[:2], radius=.05, color='yellow'))
        ax.autoscale()
    if 'masks' in g:
        height, width = g['res'] * np.array(g['masks'].shape)
        extent = (0, width, 0, height)
        cm = ax.imshow(g['masks'], extent=extent, cmap='tab20')
        ticks = np.arange(g['masks'].min(), g['masks'].max() + 1)
        plt.colorbar(cm, values=ticks, ticks=ticks)
    return fig
