"""Matplotlib rendering of env-state snapshots.

Counterpart of :mod:`megastep_tpu.plotting` (the reference
``megastep/plotting.py``): texel segments come from one ``np.repeat``
expansion, lights and poses are drawn as ``EllipseCollection`` /
``LineCollection`` artists. It works on the numpy snapshots that
:meth:`megastep_tpu_torch.core.Core.state` and
:meth:`megastep_tpu_torch.scene.Scenery.state` return, on the host; nothing
here touches a tensor or the device.

matplotlib is imported inside the functions that draw, so that this module
(and the envs that use it) import on a machine without it.
"""
import numpy as np

from . import constants

VIEW_RADIUS = 5


def _as_rgb(img_chw):
    """(C, H, W) float image → gamma-encoded (3, H, W); 1-channel images are
    treated as luminance and broadcast without gamma (depth maps)."""
    img = img_chw.astype(float)
    if img.shape[0] == 1:
        return np.broadcast_to(img, (3,) + img.shape[1:])
    return constants.gamma_encode(img)


def imshow_arrays(arrs, transpose=False):
    """Stacks ``{name: (A, C, H, W)}`` observation arrays into one displayable
    (H', W', 3) image per agent (role of reference ``plotting.py:12-30``)."""
    if transpose:  # (A, H, W, C) input
        arrs = {k: np.moveaxis(v, 3, 1) for k, v in arrs.items()}
    [A] = {v.shape[0] for v in arrs.values()}
    # Rows (one per named channel-set) concatenate along H; agents stay separate.
    return {a: np.concatenate([_as_rgb(v[a]) for v in arrs.values()], axis=1)
               .transpose(1, 2, 0)
            for a in range(A)}


def plot_images(arrs, axes=None, aspect=1, **kwargs):
    """Plots per-agent observation strips, one row per channel-set
    (role of reference ``plotting.py:32-50``)."""
    import matplotlib.pyplot as plt
    ims = imshow_arrays(arrs, **kwargs)
    A = len(ims)
    H, W = ims[0].shape[:2]
    if axes is None:
        axes = plt.subplots(A, 1, squeeze=False)[1].flatten()

    for a, ax in zip(range(A), axes):
        ax.imshow(ims[a], aspect=aspect / min(A, 4) * W / H, interpolation='none')
        ax.set(yticks=np.arange(H), ylim=(H - .5, -.5), xticks=[])
        ax.set_yticklabels(arrs.keys())
        ax.set_title(f'agent #{a}', fontdict={'color': f'C{a}', 'weight': 'bold'})
    return axes


def n_agent_texels(scenery):
    """Texel count of the dynamic agent-model lines heading each env's line array."""
    A = scenery.n_agents if 'n_agents' in scenery else 1
    M = len(scenery.model)
    return int(scenery.textures.widths[:A * M].sum())


def texel_frames(scenery):
    """Per-texel interpolation frame: for every texel, which line owns it and the
    [f0, f1) fraction of that line it covers."""
    widths = np.asarray(scenery.textures.widths)
    owner = np.repeat(np.arange(len(widths)), widths)
    local = np.arange(owner.size) - np.repeat(widths.cumsum() - widths, widths)
    f0 = local / widths[owner]
    f1 = (local + 1) / widths[owner]
    return owner, f0, f1


def line_arrays(state):
    """Splits every line into its per-texel segments and returns (segments, colors),
    where colors are the gamma-encoded baked-lit texel colors
    (role of reference ``plotting.py:57-78``)."""
    scenery = state.scenery
    owner, f0, f1 = texel_frames(scenery)
    a, b = scenery.lines[owner, 0], scenery.lines[owner, 1]
    # (T, 2 endpoints, 2 coords): lerp both fractions in one shot.
    fracs = np.stack([f0, f1], 1)[..., None]
    segments = a[:, None, :] * (1 - fracs) + b[:, None, :] * fracs

    # Agent-model texels render unlit (their bake slots are dynamic).
    lit = np.asarray(scenery.baked.vals).copy()
    lit[:n_agent_texels(scenery)] = 1.
    colors = constants.gamma_encode(scenery.textures.vals * lit[:, None])
    return segments, np.clip(colors, 0., 1.)


def plot_lights(ax, state):
    """Lights as translucent yellow discs, alpha ∝ intensity, one collection."""
    import matplotlib.collections as mcollections
    import matplotlib.colors as mcolors
    lights = np.asarray(state.scenery.lights)
    if len(lights) == 0:
        return
    intensity = lights[:, 2]
    lo, hi = intensity.min() - 1e-2, intensity.max()
    rgba = np.zeros((len(lights), 4))
    rgba[:, :3] = mcolors.to_rgb('yellow')
    rgba[:, 3] = (intensity - lo) / (hi - lo)
    ax.add_collection(mcollections.EllipseCollection(
        widths=.1, heights=.1, angles=0, units='xy', offsets=lights[:, :2],
        transOffset=ax.transData, facecolors=rgba))


def extent(state, zoom, radius=VIEW_RADIUS):
    """A square view box: around the agents (zoom) or the whole scene."""
    if zoom and 'agents' in state:
        pts = np.asarray(state.agents.positions)
        pad = radius
    else:
        pts = np.asarray(state.scenery.lines).reshape(-1, 2)
        pad = 1
    lo, hi = pts.min(0) - pad, pts.max(0) + pad
    center = (lo + hi) / 2
    half = (hi - lo).max() / 2
    return ((center[0] - half, center[0] + half),
            (center[1] - half, center[1] + half))


def plot_lines(ax, state, zoom=True):
    import matplotlib.collections as mcollections
    segments, colors = line_arrays(state)
    (l, r), (b, t) = extent(state, zoom)
    inside = ((segments > [l, b]) & (segments < [r, t])).all(-1).any(-1)
    ax.add_collection(mcollections.LineCollection(
        segments[inside], colors=colors[inside], linestyle='solid', linewidth=2))


def adjust_view(ax, state, zoom=True):
    xs, ys = extent(state, zoom)
    ax.set(xlim=xs, ylim=ys, facecolor='#c6c1b3')
    ax.set_aspect(1)


def plot_wedge(ax, angle, position, distance, fov, radians=False, **kwargs):
    import matplotlib.patches as mpatches
    deg = np.degrees(angle) if radians else angle
    ax.add_patch(mpatches.Wedge(
        position, distance, deg - fov / 2, deg + fov / 2,
        width=distance - constants.AGENT_RADIUS, **kwargs))


def plot_fov(ax, state, distance=1, field='agents'):
    agents = state[field]
    for i, (angle, pos) in enumerate(zip(agents.angles, agents.positions)):
        plot_wedge(ax, angle, pos, distance, state.fov, color=f'C{i}', alpha=.1)


def plot_poses(poses, ax=None, radians=True, color='C9', **kwargs):
    """Draws agents as circles with a heading tick, as two collections
    (role of reference ``plotting.py:131-141``)."""
    import matplotlib.collections as mcollections
    import matplotlib.pyplot as plt
    ax = ax or plt.subplot()
    positions = np.asarray(poses.positions, dtype=float)
    angles = np.asarray(poses.angles, dtype=float)
    if not radians:
        angles = np.radians(angles)
    r = constants.AGENT_RADIUS
    ax.add_collection(mcollections.EllipseCollection(
        widths=2 * r, heights=2 * r, angles=0, units='xy', offsets=positions,
        transOffset=ax.transData, edgecolors=color, facecolors='none'))
    headings = r * np.stack([np.cos(angles), np.sin(angles)], -1)
    ticks = np.stack([positions, positions + headings], 1)
    ax.add_collection(mcollections.LineCollection(ticks, colors=color))
    # Collections don't autoscale; make sure the poses are in view.
    ax.update_datalim(positions)
    ax.autoscale_view()
    return ax
