"""Observe inputs on the edges of the observe kernel's decisions.

Crafted line arrays over a real scenery's texel layout, where a shortcut of the
kernel (``csrc/observe.cu``: the one pass with a candidate mask, the
rejections without a divide) could part from its plain version: the tolerance
tie-break, segment endpoints, the parallel test, the near plane, an agent on a
line's start point; and scenes with more than 64 live line slots, past the
kernel's candidate mask. ``chip_smoke.py`` and
``tests/test_torch_observe_edges.py`` hold the kernel, and the plain version,
to them.

Every case is seen by agent 0 of its env, at the origin facing +x (angle 0).
At an odd ``res`` its middle ray is exactly (1, +0), and every ray has
``rux = 1``, so a wall ``x = d`` from y = -8 to 8 is met at ``s = d`` exactly.
"""
import numpy as np
import torch

from .. import floorplans, scene
from ..arrdict import arrdict
from ..ops import render

#: Odd, so that one ray points straight along the agent's heading.
RES = 65
#: Where the live slots that a case does not use put their (degenerate,
#: zero-length) segment.
FILLER = (50., 50.)


def _f32(x):
    return np.float32(x)


def _next(x, towards):
    return float(np.nextafter(_f32(x), _f32(towards)))


def wall(d):
    """A wall at ``x = d``, every ray's hit at ``s = d``: ``16 d / 16``."""
    return ((float(d), -8.), (float(d), 8.))


def cases(agent_radius):
    """Each case's segments in slot order, ``((x0, y0), (x1, y1))``, and the
    slot the middle ray picks, as ``name: (segments, winner)``.

    :param agent_radius: the radius the observe is called with; the middle
        ray's near plane is at ``x = f32(agent_radius)``.
    """
    edge = _f32(2) + _f32(1e-4)                 # fl(s_min + Z_TOLERANCE) at s_min = 2
    e = _f32(1e-3)                              # the parallel test's threshold
    near = float(_f32(agent_radius))            # the middle ray's rlen is 1
    return {
        # Slot 0 is a candidate until slots 1 and 2 lower the minimum.
        'later slot lowers the minimum': ([wall(3.), wall(2.5), wall(2.)], 2),
        # The nearest line comes last; the lower index within tolerance wins.
        'lower index within tolerance': ([wall(2 + _f32(5e-5)), wall(3.), wall(2.)], 0),
        # s exactly at fl(s_min + tol) is out; one ulp below it is in.
        's at the tolerance edge': ([wall(edge), wall(_next(edge, 0)), wall(2.)], 1),
        # The middle ray meets slot 0 at t = 1 + 2^-23 (out) and slot 1 at
        # t = 0; reversed, at t = -2^-24 / (1 - 2^-24) (out) and t = 1.
        'endpoints, t one ulp past 1 and t = 0': (
            [((1.5, -1.), (1.5, -2.**-24)), ((2., 0.), (2., 8.)), wall(3.)], 1),
        # The middle ray meets slot 0 at t = 1 (reversed, t = 0).
        'endpoint, t = 1': ([((2.5, -8.), (2.5, 0.)), wall(3.)], 0),
        # The middle ray's |u x v| is 1e-3 one ulp below, at and one ulp above.
        'parallel test at 1e-3': (
            [((1.5, 0.), (2.5, _next(e, 0))), ((2., 0.), (3., float(e))),
             ((2.5, 0.), (3.5, _next(e, 1))), wall(3.2)], 1),
        # Lines that start at the agent: t_num = +-0 and s_num = +-0.
        'agent on a line start': ([((0., 0.), (2., -3.)), ((0., 0.), (2., 3.)), wall(3.)], 2),
        # Walls inside, at and one ulp past the middle ray's near plane.
        'agent touching a wall': (
            [wall(near / 2), wall(near), wall(_next(near, 1)), wall(3.)], 2),
    }


def crafted(scenery, agent_radius):
    """Every case twice, as listed and with each segment reversed (which flips
    the sign of ``u x v`` and swaps t = 0 and t = 1), in envs ``2c`` and
    ``2c + 1`` of ``scenery``, after its ``n_dynamic`` head slots.

    :param scenery: ``2 * len(cases())`` envs, each with enough live slots.
        Its model slots, padding and texel layout are kept; its other live
        slots become the cases' segments, then :data:`FILLER`.
    :return: ``(lines, angles, positions, winners)``: (N, L, 2, 2) static
        lines, the head slots holding the unrotated model as in
        ``scenery.lines``; (N, A) angles, all 0; (N, A, 2) positions, agent 0
        at the origin and the others at (-40, 12 a), looking at the cases from
        afar; (N,) the line index agent 0's middle ray must pick.
    """
    both = list(cases(agent_radius).values())
    N, A = scenery.n_envs, scenery.n_agents
    if N != 2 * len(both):
        raise ValueError(f'{N} envs for {2 * len(both)} crafted ones')
    lines = scenery.lines.cpu().numpy().copy()
    width = scenery.lines_width.cpu().numpy()
    head = scenery.n_dynamic
    winners = np.zeros(N, np.int32)
    for n in range(N):
        segments, winners[n] = both[n // 2]
        case = np.asarray(segments, dtype=np.float32)
        if n % 2:
            case = case[:, ::-1]
        if width[n] < head + len(case):
            raise ValueError(f'env {n} has {width[n]} live slots for {len(case)} '
                             'segments after the models')
        lines[n, head:width[n]] = FILLER
        lines[n, head:head + len(case)] = case
    positions = np.zeros((N, A, 2), np.float32)
    positions[:, 1:, 0] = -40.
    positions[:, 1:, 1] = 12. * np.arange(1, A)
    device = scenery.lines.device
    return (torch.from_numpy(lines).to(device), torch.zeros((N, A), device=device),
            torch.from_numpy(positions).to(device),
            torch.from_numpy(winners + head).to(device))


def crafted_scenery(n_agents, device):
    """A scenery of procedural floorplans for :func:`crafted`: its texel
    layout, baked lighting and model slots are real."""
    return scene.scenery(floorplans.sample(2 * len(cases(1.)), seed=3), n_agents,
                         random=np.random.RandomState(0), device=device)


MODES = ('explorer', 'patch', 'draw_model', 'fast_div')


def mode_args(scenery, lines, angles, positions, res, half_screen_width,
              agent_radius, mode, seed=0):
    """The observe call of ``mode`` on static ``lines``, as ``(args, kwargs)``:
    Explorer's (one agent, model slots skipped, seen mask) or one of
    Deathmatch's (``baked_dyn`` from a numpy seed, no seen mask): the table
    patch and ``fast_div`` on the drawn lines, ``draw_model`` on the static
    ones. Also returns the drawn lines that every mode raycasts."""
    scn = scenery.replace(lines=lines)
    drawn = render.draw(scn, arrdict(angles=angles, positions=positions))
    common = (scn.lines_width, scn.line_tex_starts, scn.line_tex_widths,
              render.pack_table(scn), angles, positions, res, half_screen_width,
              agent_radius)
    if mode == 'explorer':
        return (lines, *common), dict(skip_dyn=scn.n_dynamic), drawn
    rng = np.random.RandomState(seed)
    dyn = torch.from_numpy(rng.uniform(.25, 1.25, (scn.n_envs, scn.n_dynamic_texels))
                           .astype(np.float32)).to(lines.device)
    kwargs = dict(want_seen=False, baked_dyn=dyn)
    if mode == 'draw_model':
        return (lines, *common), dict(kwargs, draw_model=scn.n_model_lines), drawn
    return (drawn, *common), dict(kwargs, fast_div=mode == 'fast_div'), drawn


def wide_geometries(n):
    """The first ``n`` floorplans of more than 64 walls among those of 35 m by
    35 m (the JAX package's large-scene bench, ``perf/fused_bench.py
    --geom-size 35 --geom-depth 9``; most have 70-240 walls): more than 64
    live line slots past the models."""
    geoms = [g for g in floorplans.sample(2 * n, width=35., height=35., max_depth=9,
                                          stop=.02)
             if len(g['walls']) > 64][:n]
    if len(geoms) < n:
        raise ValueError(f'{len(geoms)} floorplans of more than 64 walls, not {n}')
    return geoms


def random_poses(n, a, seed, low=2., high=30., device='cpu'):
    """Angles in [-180, 180) degrees and positions in [low, high)^2, from a
    numpy seed."""
    rng = np.random.RandomState(seed)
    angles = rng.uniform(-180, 180, (n, a)).astype(np.float32)
    positions = rng.uniform(low, high, (n, a, 2)).astype(np.float32)
    return torch.from_numpy(angles).to(device), torch.from_numpy(positions).to(device)
