"""Scene compilation: geometries -> padded device Scenery.

Counterpart of :mod:`megastep_tpu.scene`. One host-side numpy pass builds
textures, lights and lines per env and pads them to common shapes; the result is
uploaded once as a :class:`Scenery` of torch tensors and baked on its device. The
host pass consumes a ``RandomState`` in the same order as the JAX package's, so
the same seed gives the same scenery in both.

Layout invariant (same as the reference, ``kernels.cu:203`` / ``scene.py:83``): the
first ``n_agents * len(model)`` line slots of every env are the *dynamic* agent-model
lines; the static walls follow. Texels are packed line-major, so the dynamic lines'
texels are the first ``n_dynamic_texels`` texels of every env. Padded line slots are
all-zero segments, which the observe kernel relies on instead of a width mask.
"""
import dataclasses

import numpy as np
import torch

from . import constants, tracing
from .arrdict import arrdict, numpyify

# Ten bland colors (the reference's palette, scene.py:10-20).
COLORS = [
    "#c185ae", "#73a171", "#5666a4", "#9f7c4a", "#809cd5",
    "#566e40", "#8e537b", "#4f9fa4", "#b56d66", "#5a728c"]


def resolve_device(device):
    """The device an entry point runs on: ``'cuda'`` unless the caller asked for
    another. Raises when the device is a GPU and none is present — the port never
    falls back to the CPU on its own."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           'to run on the CPU')
    return device


def _to_rgb(spec):
    """Hex/named/grey-level color to an RGB triple."""
    if spec.startswith('#'):
        return np.array([int(spec[i:i + 2], 16) / 255 for i in (1, 3, 5)])
    named = {'g': (0., .5, 0.), 'r': (1., 0., 0.)}
    if spec in named:
        return np.array(named[spec])
    return np.full(3, float(spec))


def lengths(lines):
    return ((lines[..., 0, :] - lines[..., 1, :])**2).sum(-1)**.5


def agent_model():
    """The agent's octagonal body as an (8, 2, 2) array of line segments, scaled to
    the agent width (reference ``scene.py:25-33``)."""
    corners = [
        [-.5, -1.], [+.5, -1.],
        [+1., -.5], [+1., +.5],
        [+.5, +1.], [-.5, +1.],
        [-1., +.5], [-1., -.5]]
    n = len(corners)
    walls = [[corners[i], corners[(i + 1) % n]] for i in range(n)]
    return constants.AGENT_WIDTH / 2 * np.array(walls)


def agent_colors():
    """Per-edge colors of the agent model: grey flanks, green tail, red nose."""
    k, g, r = '.25', 'g', 'r'
    colors = (k, g, k, r, k, r, k, g)
    return np.stack([_to_rgb(s) for s in colors])


def resolutions(lines):
    """Texel count per line: one texel per 5 cm, rounded up (``scene.py:40-41``)."""
    return np.maximum(np.ceil(lengths(lines) / constants.TEXTURE_RES).astype(int), 1)


def texel_sizes(geometries, n_agents=1):
    """Exact per-geometry texel count (dynamic agent-model texels + wall texels)."""
    dyn = int(resolutions(np.tile(agent_model(), (n_agents, 1, 1))).sum())
    return np.array([dyn + int(resolutions(
        np.asarray(g['walls'], dtype=float)).sum()) for g in geometries])


def size_order(geometries, n_agents=1):
    """Stable ascending argsort of :func:`texel_sizes` — the permutation envs
    apply to their scene list (``env.scene_order``): env/scene ``i`` uses
    ``geometries[env.scene_order[i]]`` of the caller's original list."""
    return np.argsort(texel_sizes(geometries, n_agents), kind='stable')


def striped_order(geometries, n_agents=1, n_shards=1):
    """:func:`size_order`, striped over ``n_shards`` contiguous env-axis shards:
    env ``s * n_local + p`` gets the scene of global size rank ``p * n_shards + s``,
    so every shard's local sequence is ascending in texel count."""
    order = size_order(geometries, n_agents)
    N = len(order)
    if n_shards <= 1:
        return order
    assert N % n_shards == 0, (N, n_shards)
    n_local = N // n_shards
    idx = np.arange(N)
    return order[(idx % n_local) * n_shards + idx // n_local]


def wall_pattern(n, l=.5, random=np.random):
    """A random piecewise-constant brightness pattern giving walls depth cues
    (``scene.py:43-48``)."""
    p = constants.TEXTURE_RES / l
    jumps = random.choice(np.array([0., 1.]), p=np.array([1 - p, p]), size=n)
    jumps = jumps * random.normal(size=n)
    return .5 + .5 * (jumps.cumsum() % 1)


def init_textures(agentlines, agentcolors, walls, random=np.random):
    """Per-texel linear-RGB colors for one env: agent edges use their fixed colors,
    walls cycle the palette, and a random brightness pattern is multiplied in
    (``scene.py:50-68``)."""
    colormap = np.array([_to_rgb(c) for c in COLORS])
    wallcolors = colormap[np.arange(len(walls)) % len(colormap)]
    colors = np.concatenate([agentcolors, wallcolors])

    texwidths = resolutions(np.concatenate([agentlines, walls]))
    starts = texwidths.cumsum() - texwidths

    indices = np.full(texwidths.sum(), 0)
    indices[starts] = 1
    indices = np.cumsum(indices) - 1
    textures = constants.gamma_decode(colors[indices])

    pattern = wall_pattern(textures.shape[0], random=random)
    pattern[:texwidths[:len(agentlines)].sum()] = 1.
    textures = textures * pattern[:, None]

    return textures, texwidths


def random_lights(lights, random=np.random):
    """Appends a random U(0.5, 2) intensity column to (K, 2) light positions."""
    return np.concatenate([lights, random.uniform(.5, 2., (len(lights), 1))], -1)


def _round_up(x, m):
    return int(-(-x // m) * m)


_PER_ENV = ('lines', 'lines_width', 'lights', 'lights_width', 'textures',
            'tex_width', 'baked', 'line_tex_starts', 'line_tex_widths', 'tex_line')


@dataclasses.dataclass(frozen=True)
class Scenery:
    """The static scene of a batch of environments, as padded tensors on one device.

    All per-env variable-length data is padded to batch-max sizes with ``*_width``
    tensors recording true extents. ``baked`` holds the precomputed light intensity
    of every texel.
    """
    lines: torch.Tensor            # (N, Lmax, 2, 2) f32
    lines_width: torch.Tensor      # (N,) i32 — true line count incl. dynamic slots
    lights: torch.Tensor           # (N, Kmax, 3) f32 — x, y, intensity
    lights_width: torch.Tensor     # (N,) i32
    textures: torch.Tensor         # (N, Tmax, 3) f32 — linear RGB texels, line-major
    tex_width: torch.Tensor        # (N,) i32 — true texel count
    baked: torch.Tensor            # (N, Tmax) f32 — baked illumination per texel
    line_tex_starts: torch.Tensor  # (N, Lmax) i32 — first texel of each line
    line_tex_widths: torch.Tensor  # (N, Lmax) i32 — texel count of each line
    tex_line: torch.Tensor         # (N, Tmax) i32 — owning line of each texel
    model: torch.Tensor            # (M, 2, 2) f32 — shared agent body model
    n_agents: int
    n_dynamic_texels: int

    @property
    def device(self):
        return self.lines.device

    @property
    def n_envs(self):
        return self.lines.shape[0]

    @property
    def n_model_lines(self):
        return self.model.shape[0]

    @property
    def n_dynamic(self):
        """Number of leading line slots holding dynamic agent-model lines."""
        return self.n_agents * self.model.shape[0]

    def replace(self, **fields):
        return dataclasses.replace(self, **fields)

    def env_slice(self, g0, g1):
        """View of envs ``[g0, g1)`` — every per-env field sliced, shared/static
        fields untouched."""
        return self.replace(**{f: getattr(self, f)[g0:g1] for f in _PER_ENV})

    def state(self, e):
        """Snapshot of env ``e`` with padding trimmed, as an arrdict of numpy
        arrays on the host (``megastep_tpu/scene.py:226-240``)."""
        L = int(self.lines_width[e])
        T = int(self.tex_width[e])
        return arrdict(
            model=numpyify(self.model),
            lines=numpyify(self.lines[e, :L]),
            lights=numpyify(self.lights[e, :int(self.lights_width[e])]),
            textures=arrdict(
                vals=numpyify(self.textures[e, :T]),
                widths=numpyify(self.line_tex_widths[e, :L])),
            baked=arrdict(
                vals=numpyify(self.baked[e, :T]),
                widths=numpyify(self.line_tex_widths[e, :L])))


def padded_sizes(geometries, n_agents=1):
    """The padded (Lmax, Kmax, Tmax) this geometry list compiles to, computed
    without building any textures."""
    n_dyn = n_agents * len(agent_model())
    dyn_tex = int(resolutions(np.tile(agent_model(), (n_agents, 1, 1))).sum())
    Lmax = Kmax = Tmax = 1
    for g in geometries:
        walls = np.asarray(g['walls'], dtype=float)
        Lmax = max(Lmax, n_dyn + len(walls))
        Kmax = max(Kmax, len(g['lights']))
        Tmax = max(Tmax, dyn_tex + int(resolutions(walls).sum()))
    return _round_up(Lmax, 16), _round_up(Kmax, 4), _round_up(Tmax, 128)


def scenery(geometries, n_agents=1, random=None, bake_fn='auto', pad_to=None,
            device='cuda'):
    """Compiles a list of geometries into a single padded :class:`Scenery` on
    ``device`` and bakes the static lighting there.

    :param geometries: list of geometry dotdicts (walls, lights, masks, res).
    :param n_agents: agents per env; their model lines head each env's line array.
    :param random: numpy RandomState for texture patterns and light intensities
        (numpy's global state when None, as in the JAX package).
    :param bake_fn: 'auto' to run the standard bake, None to leave ``baked`` as ones.
    :param pad_to: optional (Lmax, Kmax, Tmax) from :func:`padded_sizes`.
    :param device: where the tensors live; ``'cuda'`` unless the caller says so.
    """
    with tracing.span('scene.scenery'):
        device = resolve_device(device)
        random = np.random if random is None else random
        agentlines = np.tile(agent_model(), (n_agents, 1, 1))
        acolors = np.tile(agent_colors(), (n_agents, 1))

        per_env = []
        for g in geometries:
            lights = random_lights(np.asarray(g['lights'], dtype=float), random)
            walls = np.asarray(g['walls'], dtype=float)
            lines = np.concatenate([agentlines, walls])
            textures, texwidths = init_textures(agentlines, acolors, walls, random)
            per_env.append((lights, lines, textures, texwidths))

        N = len(per_env)
        if pad_to is None:
            Lmax = _round_up(max(len(p[1]) for p in per_env), 16)
            Kmax = _round_up(max(max(len(p[0]) for p in per_env), 1), 4)
            Tmax = _round_up(max(len(p[2]) for p in per_env), 128)
        else:
            Lmax, Kmax, Tmax = pad_to
            assert Lmax >= max(len(p[1]) for p in per_env), 'pad_to Lmax too small'
            assert Kmax >= max(len(p[0]) for p in per_env), 'pad_to Kmax too small'
            assert Tmax >= max(len(p[2]) for p in per_env), 'pad_to Tmax too small'

        lines = np.zeros((N, Lmax, 2, 2), np.float32)
        lines_width = np.zeros(N, np.int32)
        lights = np.zeros((N, Kmax, 3), np.float32)
        lights_width = np.zeros(N, np.int32)
        textures = np.zeros((N, Tmax, 3), np.float32)
        tex_width = np.zeros(N, np.int32)
        line_tex_starts = np.zeros((N, Lmax), np.int32)
        line_tex_widths = np.zeros((N, Lmax), np.int32)
        tex_line = np.zeros((N, Tmax), np.int32)

        for n, (K, L, tex, texw) in enumerate(per_env):
            lines[n, :len(L)] = L
            lines_width[n] = len(L)
            lights[n, :len(K)] = K
            lights_width[n] = len(K)
            textures[n, :len(tex)] = tex
            tex_width[n] = len(tex)
            starts = texw.cumsum() - texw
            line_tex_starts[n, :len(L)] = starts
            line_tex_widths[n, :len(L)] = texw
            owner = np.zeros(len(tex), np.int32)
            owner[starts] = 1
            tex_line[n, :len(tex)] = owner.cumsum() - 1

        up = lambda x: torch.from_numpy(x).to(device)
        scn = Scenery(
            lines=up(lines),
            lines_width=up(lines_width),
            lights=up(lights),
            lights_width=up(lights_width),
            textures=up(textures),
            tex_width=up(tex_width),
            baked=torch.ones((N, Tmax), dtype=torch.float32, device=device),
            line_tex_starts=up(line_tex_starts),
            line_tex_widths=up(line_tex_widths),
            tex_line=up(tex_line),
            model=up(agent_model().astype(np.float32)),
            n_agents=n_agents,
            n_dynamic_texels=int(resolutions(agentlines).sum()))

        if bake_fn == 'auto':
            from .ops import bake
            scn = bake.bake(scn)
        return scn


def display(scn, e=0):
    """Plots the scenery of env ``e`` (``megastep_tpu/scene.py:344-353``)."""
    import matplotlib.pyplot as plt
    from . import plotting
    ax = plt.axes()
    state = arrdict(scenery=scn.state(e))
    plotting.plot_lines(ax, state, zoom=False)
    plotting.plot_lights(ax, state)
    plotting.adjust_view(ax, state, zoom=False)
    return ax.figure
