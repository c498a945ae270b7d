"""Dependency-free polygon booleans for the floorplan pipeline.

A numpy copy of :mod:`megastep_tpu.polygons` (the port imports nothing of the
JAX package). The reference leans on shapely for one operation
(``megastep/geometry.py:43-57``): ``boundary(union(wall polygons) - dilated door
polygons)``, yielding the wall segments the engine consumes. This module
computes the same thing exactly (no rasterization) with plain numpy:

1. collect every candidate edge — wall-polygon edges plus dilated-door edges;
2. split each edge at its intersections with every other edge;
3. keep a sub-segment iff it lies on the region boundary: sampling just off its
   midpoint on both sides, exactly one side is inside
   ``union(walls) - union(doors)``;
4. orient kept segments so the solid region lies on their left (CCW convention),
   and drop exact duplicates.

Unlike the reference (which keeps only exterior rings of the shapely result),
hole boundaries — rooms fully enclosed by a connected wall component — are kept:
they are real walls. Divergence documented in PARITY.md.
"""
import numpy as np


def _cross2(a, b):
    """z-component of the 2-D cross product (numpy deprecated 2-D np.cross)."""
    a, b = np.asarray(a), np.asarray(b)
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


# Coordinates are SVG centimeters; 1e-3 cm = 10 µm resolves any real layout.
EPS = 1e-3


def polygon_edges(poly):
    """(P, 2) vertex loop → (P, 2, 2) edge array (closing edge included)."""
    poly = np.asarray(poly, dtype=float)
    return np.stack([poly, np.roll(poly, -1, axis=0)], axis=1)


def points_in_polygon(points, poly):
    """Even-odd (crossing-number) containment test, vectorized over points.

    Points exactly on the boundary are classified arbitrarily — callers sample
    strictly off-boundary points, so this never matters here.
    """
    points = np.asarray(points, dtype=float)
    x, y = points[..., 0, None], points[..., 1, None]
    a, b = polygon_edges(poly).transpose(1, 0, 2)  # (P, 2) each
    ax, ay, bx, by = a[:, 0], a[:, 1], b[:, 0], b[:, 1]
    # Edge straddles the horizontal ray through y...
    straddles = (ay <= y) != (by <= y)
    # ...and the crossing lies right of x.
    with np.errstate(divide='ignore', invalid='ignore'):
        cross_x = ax + (y - ay) * (bx - ax) / (by - ay)
    return ((straddles & (cross_x > x)).sum(-1) % 2).astype(bool)


def dilate_convex(poly, r):
    """Offsets a convex polygon outward by ``r`` with miter joins: push each edge
    out along its normal and re-intersect consecutive edge lines. (Shapely's
    ``buffer`` rounds the corners instead; the difference is confined to
    r-sized corner neighborhoods.) Non-convex inputs are replaced by their
    convex hull — cubicasa door polygons are rectangles in practice."""
    poly = _hull(np.asarray(poly, dtype=float))
    edges = polygon_edges(poly)
    d = edges[:, 1] - edges[:, 0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # CCW polygon: outward normal is (dy, -dx).
    n = np.stack([d[:, 1], -d[:, 0]], 1)
    p = edges[:, 0] + r * n  # a point on each offset edge line
    out = []
    for i in range(len(poly)):
        j = (i - 1) % len(poly)
        # Intersect offset lines j and i: p_j + t*d_j = p_i + s*d_i.
        den = _cross2(d[j], d[i])
        if abs(den) < 1e-12:  # collinear edges: the shared offset point
            out.append(p[i])
        else:
            t = _cross2(p[i] - p[j], d[i]) / den
            out.append(p[j] + t * d[j])
    return np.array(out)


def _hull(points):
    """Andrew's monotone chain, CCW."""
    pts = points[np.lexsort((points[:, 1], points[:, 0]))]
    if len(pts) <= 2:
        return pts

    def half(iterable):
        chain = []
        for q in iterable:
            while len(chain) >= 2 and _cross2(chain[-1] - chain[-2],
                                               q - chain[-2]) <= 0:
                chain.pop()
            chain.append(q)
        return chain

    lower, upper = half(pts), half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1])


def _split_at_crossings(segments):
    """Splits every segment at its intersections with every other segment.

    Exact parametric line-line intersection; endpoint touches and collinear
    overlaps contribute split points too (via endpoint projection).
    """
    segments = np.asarray(segments, dtype=float)
    S = len(segments)
    a = segments[:, 0]
    v = segments[:, 1] - segments[:, 0]
    lengths = np.linalg.norm(v, axis=1)

    pieces = []
    for i in range(S):
        if lengths[i] < EPS:
            continue
        # Proper crossings: solve a_i + t v_i = a_j + u v_j for all j.
        den = _cross2(v[i], v)                       # (S,)
        diff = a - a[i]                               # (S, 2)
        with np.errstate(divide='ignore', invalid='ignore'):
            t = _cross2(diff, v) / den
            u = _cross2(diff, v[i]) / den
        valid = (np.abs(den) > 1e-12) & (t > -1e-12) & (t < 1 + 1e-12) \
            & (u > -1e-12) & (u < 1 + 1e-12)
        ts = t[valid]

        # Collinear/touching endpoints: project all other endpoints onto i.
        ends = segments.reshape(-1, 2) - a[i]
        te = ends @ v[i] / (lengths[i] ** 2)
        on_line = np.abs(_cross2(ends, v[i])) / lengths[i] < EPS
        ts = np.concatenate([ts, te[on_line & (te > 0) & (te < 1)], [0., 1.]])

        ts = np.unique(np.clip(ts, 0., 1.))
        cuts = a[i] + ts[:, None] * v[i]
        keep = np.linalg.norm(np.diff(cuts, axis=0), axis=1) > EPS
        pieces.append(np.stack([cuts[:-1][keep], cuts[1:][keep]], 1))
    return np.concatenate(pieces) if pieces else np.empty((0, 2, 2))


def boundary_segments(solids, cuts=(), eps=1e-6):
    """Boundary of ``union(solids) - union(cuts)`` as oriented segments.

    ``eps`` is the side-sampling offset: far above double-precision noise at
    floorplan coordinate scales, far below any real wall thickness.

    :param solids: list of (P, 2) simple polygons (any orientation).
    :param cuts: list of (P, 2) polygons subtracted from the union.
    :return: (N, 2, 2) segments with the solid region on their left.
    """
    solids = [np.asarray(p, float) for p in solids]
    cuts = [np.asarray(p, float) for p in cuts]
    edges = [polygon_edges(p) for p in solids + cuts]
    if not edges:
        return np.empty((0, 2, 2))
    pieces = _split_at_crossings(np.concatenate(edges))

    mid = pieces.mean(1)
    tangent = pieces[:, 1] - pieces[:, 0]
    tangent /= np.linalg.norm(tangent, axis=1, keepdims=True)
    left = np.stack([-tangent[:, 1], tangent[:, 0]], 1)

    def solid(points):
        inside = np.zeros(len(points), dtype=bool)
        for p in solids:
            inside |= points_in_polygon(points, p)
        for p in cuts:
            inside &= ~points_in_polygon(points, p)
        return inside

    lhs = solid(mid + eps * left)
    rhs = solid(mid - eps * left)
    on_boundary = lhs ^ rhs
    kept = pieces[on_boundary]
    # Solid on the left (CCW exterior convention); flip the others.
    flip = rhs[on_boundary]
    kept[flip] = kept[flip][:, ::-1]
    return _dedupe(kept)


def _dedupe(segments, tol=EPS):
    """Drops segments identical to an earlier one (either direction).

    O(N log N): endpoints quantize to the tolerance grid and each segment
    canonicalizes to its lexicographically-smaller direction, so duplicates
    (which come from exactly-coincident geometry) collapse under np.unique —
    a pairwise-distance matrix over thousands of boundary pieces would burn
    GBs per floorplan under the conversion pool's fan-out.
    """
    if not len(segments):
        return segments
    q = np.round(segments / tol).astype(np.int64)
    fwd = q.reshape(len(q), -1)
    rev = q[:, ::-1].reshape(len(q), -1)
    # Per row, the lexicographically smaller of (fwd, rev).
    diff = fwd != rev
    col = diff.argmax(1)
    rows = np.arange(len(q))
    swap = diff.any(1) & (rev[rows, col] < fwd[rows, col])
    canon = np.where(swap[:, None], rev, fwd)
    _, keep = np.unique(canon, axis=0, return_index=True)
    return segments[np.sort(keep)]
