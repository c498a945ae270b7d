"""The cubicasa5k floorplan dataset pipeline.

Counterpart of :mod:`megastep_tpu.cubicasa` (the reference
``megastep/cubicasa.py:39-224``): a license-gated download of the 5k-floorplan
SVG dataset, a cached SVG→geometry conversion, and a deterministic train/test
sampler. Like the JAX module, when neither the geometry cache nor the dataset
zip is available, :func:`sample` falls back to
:mod:`megastep_tpu_torch.floorplans` procedural layouts (same schema) with a
warning, so the envs run offline.

The conversion is numpy and the standard library only: it runs where neither
bs4 nor lxml is installed, and its process pool's workers import neither torch
nor CUDA. Two differences from the JAX module:

* **The markup parser.** The JAX module parses with bs4 over lxml, whose
  recovering parser accepts some malformed files; this one parses with
  ``xml.etree.ElementTree``, which rejects them. :func:`safe_geometry` skips a
  file that fails to parse, so such a file drops out of the port's dataset and
  not of the JAX package's. An unclosed element shows it:
  ``<svg><g class="Wall"><polygon points="0,0 1,0 1,1"></g></svg>`` gives one
  wall under bs4 and a ``ParseError`` here.
* **The cache file.** The JAX cache is a pickle of ``megastep_tpu`` objects,
  and unpickling it would import the JAX package. The port reads and writes
  only its own file, ``geometries-torch-v{CACHE_VERSION}.pkl.gz``, in the same
  ``ROOT``, so one dataset zip serves both packages.
"""
import gzip
import logging
import os
import pickle
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from . import geometry, floorplans, polygons
from .constants import MARGIN, SVG_SCALE
from .dotdict import dotdict

log = logging.getLogger(__name__)

ROOT = Path(os.environ.get('MEGASTEP_TPU_CACHE', '.cache/megastep_tpu')) / 'cubicasa'

URL = 'https://zenodo.org/record/2613548/files/cubicasa5k.zip?download=1'

LICENSE_TEXT = """The cubicasa5k dataset is derived from real Finnish floorplans and
is distributed under the CC BY-NC 4.0 license (non-commercial use, attribution
required): https://zenodo.org/record/2613548 . Set the environment variable
MEGASTEP_TPU_CUBICASA_AGREE=1 to confirm you accept these terms."""

N_TEST = 500

#: Bump when the SVG→geometry conversion changes meaning (coordinates,
#: booleans, door handling): stale geometry caches are ignored by name.
CACHE_VERSION = 2


def confirm():
    """License confirmation gate (reference ``cubicasa.py:39-63``): refuses to
    download until the CC BY-NC terms are accepted via env var or interactively."""
    if os.environ.get('MEGASTEP_TPU_CUBICASA_AGREE') == '1':
        return True
    try:
        answer = input(LICENSE_TEXT + '\nAccept? [y/N] ')
    except (EOFError, OSError):
        raise RuntimeError(LICENSE_TEXT)
    if answer.strip().lower() not in ('y', 'yes'):
        raise RuntimeError('cubicasa license not accepted')
    return True


def download(url=URL, dest=None):
    """Streams the 5 GB dataset zip to the cache (reference ``cubicasa.py:65-75``)."""
    import urllib.request
    confirm()
    dest = Path(dest) if dest else ROOT / 'cubicasa5k.zip'
    dest.parent.mkdir(parents=True, exist_ok=True)
    log.info('Downloading %s to %s', url, dest)
    urllib.request.urlretrieve(url, dest)
    return dest


def _points(attr):
    return np.array([list(map(float, p.split(','))) for p in attr.split()])


def _classes(e):
    """Class tokens of an element (none for a missing one)."""
    return [] if e is None else e.get('class', '').split()


def _local(tag):
    """A tag without its namespace: ``{http://www.w3.org/2000/svg}g`` → ``g``."""
    return tag.rsplit('}', 1)[-1]


def svg_elements(svg):
    """Extracts the raw cubicasa SVG elements: wall/railing polygons, door
    polygons, and space outlines.

    Selection matches the reference's CSS rules (``geometry.py:43-57``:
    ``.Wall>polygon``, ``.Door>polygon``, ``.Space>polygon``) on real cubicasa
    markup, where Door groups nest *inside* Wall groups and Space groups carry
    multi-token classes (``Space LivingRoom``) plus nested FixedFurniture — only
    polygons whose *direct parent* carries the class count, one polygon each.
    ElementTree keeps no parent links, so a child→parent map stands in.

    :return: dotdict of ``walls``/``doors``/``spaces`` — lists of (P, 2) point
        arrays in SVG (cm) coordinates.
    """
    root = ET.fromstring(svg)
    parents = {child: parent for parent in root.iter() for child in parent}

    walls, doors, spaces = [], [], []
    buckets = [(('Wall', 'Railing'), walls), (('Door',), doors),
               (('Space',), spaces)]
    for poly in root.iter():
        if _local(poly.tag) != 'polygon':
            continue
        pts = _points(poly.get('points', ''))
        if len(pts) < 3:
            continue
        parent = set(_classes(parents.get(poly)))
        for names, bucket in buckets:
            if parent & set(names):
                bucket.append(pts)
                break
    return dotdict(walls=walls, doors=doors, spaces=spaces)


def svg_walls(svg, door_dilation=5.):
    """Parses wall segments from a cubicasa SVG: boundary of the wall-polygon
    union minus dilated door polygons (reference ``geometry.py:43-57``, which
    used shapely; :mod:`megastep_tpu_torch.polygons` computes it exactly).
    Doors are dilated 5 cm before subtraction because real-dataset door
    polygons are often slightly misaligned with their wall."""
    els = svg_elements(svg)
    doors = [polygons.dilate_convex(pts, door_dilation) for pts in els.doors]
    walls = polygons.boundary_segments(els.walls, doors)
    return walls, els.spaces


def svg_geometry(id, svg):
    """One SVG → geometry dict: cm→m scaling with a y-flip (SVG coordinates are
    centimeters from the top-left, the engine wants meters from the bottom-left
    — reference ``geometry.py:62-72``), wall dedupe, masks, centroid lights."""
    walls, spaces = svg_walls(svg)
    joint = np.concatenate([walls.reshape(-1, 2)] +
                           [np.asarray(s) for s in spaces])
    left, bot = joint[:, 0].min(), joint[:, 1].max()

    def to_meters(ps):
        ps = np.asarray(ps)
        flipped = np.stack([ps[..., 0] - left, bot - ps[..., 1]], -1)
        return flipped / SVG_SCALE + MARGIN

    walls = geometry.unique(to_meters(walls))
    spaces = [to_meters(s) for s in spaces]
    masks = geometry.masks(walls, spaces)
    lights = geometry.centroids(spaces)
    return dotdict(id=id, walls=walls, lights=lights, masks=masks, res=geometry.RES)


def safe_geometry(id, svg):
    """:func:`svg_geometry` that returns None (with a warning) on malformed
    markup instead of killing the batch conversion (the dataset has a handful
    of broken files — reference ``cubicasa.py:128-136``)."""
    try:
        return svg_geometry(id, svg)
    except Exception as e:  # noqa: BLE001 — any parse failure just skips the file
        log.warning('Skipping %s: %s', id, e)
        return None


def cache_path():
    """The port's geometry cache in ``ROOT``."""
    return ROOT / f'geometries-torch-v{CACHE_VERSION}.pkl.gz'


def geometry_data(regenerate=False, backend='process'):
    """Loads (building if needed) the geometry cache: a gzipped pickle of geometry
    dicts converted from the dataset SVGs in ``ROOT / 'cubicasa5k.zip'``.
    Conversion fans out over a pool like the reference's regeneration path
    (``cubicasa.py:149-160``). Downloads the zip if it is missing.

    :param backend: pool backend for the conversion ('process'/'thread'/'serial').
    """
    cache = cache_path()
    if cache.exists() and not regenerate:
        with gzip.open(cache, 'rb') as f:
            return pickle.load(f)

    import zipfile
    from .rebar.parallel import parallel
    zpath = ROOT / 'cubicasa5k.zip'
    if not zpath.exists():
        download()
    # Stream entries out of the zip in bounded batches: the full dataset's
    # SVGs are hundreds of MB and pending submissions pin their arguments.
    geoms = []
    with zipfile.ZipFile(zpath) as z, \
            parallel(safe_geometry, backend=backend) as pool:
        names = sorted(n for n in z.namelist() if n.endswith('model.svg'))
        for i in range(0, len(names), 64):
            batch = names[i:i + 64]
            geoms += pool.wait([pool(n, z.read(n).decode('utf8'))
                                for n in batch])
    geoms = [g for g in geoms if g is not None]
    cache.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(cache, 'wb') as f:
        pickle.dump(geoms, f)
    return geoms


def sample(n, split='training', fallback='procedural'):
    """Deterministically samples ``n`` geometries from the given split
    (reference ``cubicasa.py:177-224``: the last ``N_TEST`` of a seeded shuffle
    are the test split; the picks are the JAX package's draws).

    When the dataset cache is missing and can't be fetched, falls back to
    :func:`megastep_tpu_torch.floorplans.sample` procedural geometries (same
    schema) so everything downstream runs offline; pass ``fallback=None`` to
    forbid that.
    """
    try:
        geoms = geometry_data()
    except Exception as e:
        if fallback != 'procedural':
            raise
        log.warning('cubicasa unavailable (%s); using procedural floorplans', e)
        return floorplans.sample(n, seed=1 if split == 'training' else 2)

    order = np.random.RandomState(1).permutation(len(geoms))
    pool = order[:-N_TEST] if split == 'training' else order[-N_TEST:]
    picks = np.random.RandomState(2).choice(pool, n, replace=n > len(pool))
    return [geoms[i] for i in picks]
