"""The plain reference of the two worlds the benchmark runs: Explorer and
Deathmatch, from the floorplans to each step's observations, rewards and state.

Plain torch and numpy, written from the reference megastep's semantics as the
port states them (``megastep/demo/envs/{explorer,deathmatch}.py``,
``megastep/cuda/kernels.cu``): the host scene pass (textures, lights, line and
texel tables), the light bake with hard shadows, the spawn tables, momentum
movement with collision resolution, the 1-D raycast with the lowest-index
nearest hit, the two-tap texture shade, the seen-texel reward, Deathmatch's
per-frame model draw and re-bake, and its shoot test. It imports nothing of the
program and takes nothing the program made: it builds every table again from
the plans and the seed.

Every float computation takes a ``dtype``: float32 is the configuration's
precision; bfloat16 is the control that has to fail the comparison.
"""
import math

import numpy as np
import torch

AGENT_WIDTH = .15
TEXTURE_RES = .05
AGENT_RADIUS = 1 / 2**.5 * AGENT_WIDTH
AMBIENT, LUMINANCE = .1, 2.
PARALLEL_EPS = 1e-3
Z_TOLERANCE = 1e-4
N_SPAWNS = 100
COLORS = ["#c185ae", "#73a171", "#5666a4", "#9f7c4a", "#809cd5",
          "#566e40", "#8e537b", "#4f9fa4", "#b56d66", "#5a728c"]
# noop, forward/backward, strafe left/right, turn left/right.
VELOCITY_BASIS = np.array([[0., 0.], [0., 1.], [0., -1.], [1., 0.], [-1., 0.], [0., 0.], [0., 0.]])
ANGVELOCITY_BASIS = np.array([0., 0., 0., 0., 0., +1., -1.])
FLOAT_KEYS = ('lines', 'lights', 'textures', 'baked', 'model', 'spawn_positions',
              'spawn_angles', 'bounds')


# --- the host scene pass ---------------------------------------------------

def _rgb(spec):
    if spec.startswith('#'):
        return np.array([int(spec[i:i + 2], 16) / 255 for i in (1, 3, 5)])
    named = {'g': (0., .5, 0.), 'r': (1., 0., 0.)}
    return np.array(named[spec] if spec in named else (float(spec),) * 3)


def agent_model():
    """The octagonal body, (8, 2, 2) segments."""
    c = [[-.5, -1.], [+.5, -1.], [+1., -.5], [+1., +.5], [+.5, +1.], [-.5, +1.],
         [-1., +.5], [-1., -.5]]
    return AGENT_WIDTH / 2 * np.array([[c[i], c[(i + 1) % 8]] for i in range(8)])


def _resolutions(lines):
    lengths = ((lines[..., 0, :] - lines[..., 1, :])**2).sum(-1)**.5
    return np.maximum(np.ceil(lengths / TEXTURE_RES).astype(int), 1)


def scene_order(plans, n_agents):
    """Scenes sorted by texel count, stably: the order the envs lay them out."""
    dyn = int(_resolutions(np.tile(agent_model(), (n_agents, 1, 1))).sum())
    sizes = [dyn + int(_resolutions(np.asarray(p['walls'], float)).sum()) for p in plans]
    return np.argsort(sizes, kind='stable')


def _textures(agentlines, agentcolors, walls, random):
    wallcolors = np.array([_rgb(c) for c in COLORS])[np.arange(len(walls)) % len(COLORS)]
    colors = np.concatenate([agentcolors, wallcolors])
    widths = _resolutions(np.concatenate([agentlines, walls]))
    starts = widths.cumsum() - widths
    owner = np.zeros(widths.sum(), int)
    owner[starts] = 1
    textures = colors[owner.cumsum() - 1]**2.2
    p = TEXTURE_RES / .5
    jumps = random.choice(np.array([0., 1.]), p=np.array([1 - p, p]), size=len(textures))
    pattern = .5 + .5 * ((jumps * random.normal(size=len(textures))).cumsum() % 1)
    pattern[:widths[:len(agentlines)].sum()] = 1.
    return textures * pattern[:, None], widths


def _spawn_points(plan, n_agents, random):
    sample = np.stack((np.asarray(plan['masks']) > 0).nonzero(), -1)
    n = min(len(sample) // n_agents, N_SPAWNS)
    sample = sample[random.choice(np.arange(len(sample)), (n, n_agents), replace=True)]
    sample = np.concatenate([sample] * int(N_SPAWNS / len(sample) + 1))[-N_SPAWNS:]
    sample = random.permutation(sample)
    i, j = sample[..., 0] + .5, sample[..., 1] + .5
    h = plan['masks'].shape[0]
    return (plan['res'] * np.stack([j, h - i], -1)).transpose(1, 0, 2)


def _up(x, m):
    return int(-(-x // m) * m)


def build(plans, n_agents, random, device, res, fov, subsample, bake_chunk=512):
    """The world's static tables from the plans (already in scene order) and
    the numpy ``random`` the scene pass, then the spawn tables, draw from.

    :return: dict of tensors and settings.
    """
    model = agent_model()
    agentlines = np.tile(model, (n_agents, 1, 1))
    colors = np.tile(np.stack([_rgb(s) for s in ('.25', 'g', '.25', 'r', '.25', 'r',
                                                 '.25', 'g')]), (n_agents, 1))
    per = []
    for p in plans:
        lights = np.asarray(p['lights'], float)
        lights = np.concatenate([lights, random.uniform(.5, 2., (len(lights), 1))], -1)
        walls = np.asarray(p['walls'], float)
        tex, widths = _textures(agentlines, colors, walls, random)
        per.append((lights, np.concatenate([agentlines, walls]), tex, widths))
    N = len(per)
    L = _up(max(len(q[1]) for q in per), 16)
    K = _up(max(max(len(q[0]) for q in per), 1), 4)
    T = _up(max(len(q[2]) for q in per), 128)
    w = dict(lines=np.zeros((N, L, 2, 2), np.float32), lines_width=np.zeros(N, np.int32),
             lights=np.zeros((N, K, 3), np.float32), lights_width=np.zeros(N, np.int32),
             textures=np.zeros((N, T, 3), np.float32), tex_width=np.zeros(N, np.int32),
             line_tex_starts=np.zeros((N, L), np.int32),
             line_tex_widths=np.zeros((N, L), np.int32), tex_line=np.zeros((N, T), np.int32))
    for n, (k, l, tex, widths) in enumerate(per):
        w['lines'][n, :len(l)] = l
        w['lines_width'][n] = len(l)
        w['lights'][n, :len(k)] = k
        w['lights_width'][n] = len(k)
        w['textures'][n, :len(tex)] = tex
        w['tex_width'][n] = len(tex)
        starts = widths.cumsum() - widths
        w['line_tex_starts'][n, :len(l)] = starts
        w['line_tex_widths'][n, :len(l)] = widths
        owner = np.zeros(len(tex), np.int32)
        owner[starts] = 1
        w['tex_line'][n, :len(tex)] = owner.cumsum() - 1
    spawn_positions = np.stack([_spawn_points(p, n_agents, random) for p in plans])
    spawn_angles = random.uniform(-180, +180, (N, n_agents, N_SPAWNS))
    bounds = np.stack([np.array(p['masks'].shape) * p['res'] for p in plans])

    world = {k: torch.from_numpy(v).to(device) for k, v in w.items()}
    for k, v in (('spawn_positions', spawn_positions), ('spawn_angles', spawn_angles),
                 ('bounds', bounds), ('model', model)):
        world[k] = torch.from_numpy(np.asarray(v, np.float32)).to(device)
    world.update(n_agents=n_agents, n_dynamic=n_agents * len(model),
                 n_dynamic_texels=int(_resolutions(agentlines).sum()), res=res,
                 half_screen_width=float(np.tan(np.pi / 180 * fov / 2)), subsample=subsample,
                 k_lights=int(w['lights_width'].max()))
    world['baked'] = bake(world, torch.float32, bake_chunk)
    return world


def cast(world, dtype):
    """The world with its float tables in ``dtype``."""
    return {k: (v.to(dtype) if k in FLOAT_KEYS else v) for k, v in world.items()}


def slice_envs(world, n0, n1):
    """Envs (scenes) ``[n0, n1)`` of the world."""
    return {k: (v[n0:n1] if torch.is_tensor(v) and k != 'model' else v)
            for k, v in world.items()}


# --- light ---------------------------------------------------------------

def texel_points(lines, tex_line, starts, widths, t0, T):
    """World coordinates of texel centers ``t0 : t0 + T``, (N, T, 2)."""
    tl = tex_line[:, t0:t0 + T].long()
    s = torch.gather(starts, 1, tl)
    wd = torch.gather(widths, 1, tl)
    ab = torch.gather(lines.reshape(*lines.shape[:2], 4), 1, tl[..., None].expand(-1, -1, 4))
    t = t0 + torch.arange(T, dtype=torch.int32, device=lines.device)[None]
    loc = torch.div(t - s + .5, torch.clamp(wd, min=1).to(lines.dtype)).to(lines.dtype)
    return ab[..., 0:2] * (1 - loc[..., None]) + ab[..., 2:4] * loc[..., None]


def intensity_at(points, walls, walls_width, lights, lights_width):
    """Light at each point from every light in sight past the walls (slots
    below ``walls_width`` occlude), plus ambient, clamped to 1. (N, P)."""
    dev = points.device
    Ix, Iy, Ii = (lights[:, None, :, i] for i in range(3))
    Cx, Cy = points[:, :, None, 0], points[:, :, None, 1]
    Ux, Uy = (Cx - Ix)[..., None], (Cy - Iy)[..., None]
    ax, ay = walls[:, None, None, :, 0, 0], walls[:, None, None, :, 0, 1]
    vx, vy = walls[:, None, None, :, 1, 0] - ax, walls[:, None, None, :, 1, 1] - ay
    uxv = Ux * vy - Uy * vx
    pqx, pqy = ax - Ix[..., None], ay - Iy[..., None]
    distant = uxv.abs() < PARALLEL_EPS
    safe = torch.where(distant, 1., uxv)
    s = torch.where(distant, math.inf, (pqx * vy - pqy * vx) / safe)
    t = torch.where(distant, math.inf, (pqx * Uy - pqy * Ux) / safe)
    live = torch.arange(walls.shape[1], device=dev) < walls_width[:, None]
    blocked = ((t > 0.) & (t < 1.) & (s > 0.) & (s < .999) & live[:, None, None]).any(-1)
    d2 = (Ix - Cx)**2 + (Iy - Cy)**2
    lit = ~blocked & (torch.arange(lights.shape[1], device=dev)[None, None]
                      < lights_width[:, None, None])
    total = AMBIENT + torch.where(lit, LUMINANCE * Ii / torch.clamp(d2, min=1.), 0.).sum(-1)
    return torch.clamp(total, max=1.)


def bake(world, dtype, chunk=512):
    """Every texel's static light, the static walls occluding; padding 1."""
    nd = world['n_dynamic']
    lines = world['lines'].to(dtype)
    lights = world['lights'].to(dtype)
    N, T = world['tex_line'].shape
    out = torch.ones((N, T), dtype=dtype, device=lines.device)
    for n0 in range(0, N, chunk):
        n1 = min(n0 + chunk, N)
        for t0 in range(0, T, chunk):
            tt = min(chunk, T - t0)
            C = texel_points(lines[n0:n1], world['tex_line'][n0:n1],
                             world['line_tex_starts'][n0:n1],
                             world['line_tex_widths'][n0:n1], t0, tt)
            out[n0:n1, t0:t0 + tt] = intensity_at(
                C, lines[n0:n1, nd:], world['lines_width'][n0:n1] - nd,
                lights[n0:n1], world['lights_width'][n0:n1])
    mask = torch.arange(T, device=out.device)[None] < world['tex_width'][:, None]
    return torch.where(mask, out, 1.)


# --- movement and collisions --------------------------------------------

def _sens(p):
    return torch.where(torch.isnan(p), 0., torch.clamp(p * .99, 0., 1.))


def _disc_disc(p0, u0, p1, u1, r):
    ux, uy = u0[..., 0] - u1[..., 0], u0[..., 1] - u1[..., 1]
    qx, qy = p1[..., 0] - p0[..., 0], p1[..., 1] - p0[..., 1]
    ulen = torch.sqrt(ux * ux + uy * uy) + 1e-6
    s = (qx * ux + qy * uy) / (ulen * ulen)
    d = (qx * uy - qy * ux).abs() / ulen
    back = torch.sqrt(torch.clamp(r * r - d * d, min=0.)) / torch.sqrt(ux * ux + uy * uy)
    return torch.where((0 < s) & (d < r), _sens(s - back), 1.)


def _disc_line(px, py, ux, uy, ax, ay, bx, by, r):
    vx, vy = bx - ax, by - ay
    x = torch.ones(torch.broadcast_shapes(px.shape, ax.shape), dtype=px.dtype, device=px.device)
    uxv = ux * vy - uy * vx
    qx, qy = ax - px, ay - py
    distant = uxv.abs() < PARALLEL_EPS
    safe = torch.where(distant, 1., uxv)
    ms = torch.where(distant, math.inf, (qx * vy - qy * vx) / safe)
    mt = torch.where(distant, math.inf, (qx * uy - qy * ux) / safe)
    vlen = torch.sqrt(vx * vx + vy * vy) + 1e-6
    dp = ((px - ax) * vy - (py - ay) * vx).abs() / vlen
    hit = (0 < ms) & (ms < 1) & (0 < mt) & (mt < 1)
    x = torch.minimum(x, torch.where(
        hit, _sens((1 - torch.div(torch.full((), r, dtype=dp.dtype, device=dp.device), dp)) * ms),
        1.))
    ulen = torch.sqrt(ux * ux + uy * uy) + 1e-6
    speed = torch.sqrt(ux * ux + uy * uy)
    for ex, ey in ((ax, ay), (bx, by)):
        s = ((ex - px) * ux + (ey - py) * uy) / (ulen * ulen)
        d = ((ex - px) * uy - (ey - py) * ux).abs() / ulen
        back = torch.sqrt(torch.clamp(r * r - d * d, min=0.)) / speed
        x = torch.minimum(x, torch.where((0 < s) & (d < r), _sens(s - back), 1.))
    wx, wy = (px + ux) - ax, (py + uy) - ay
    ss = (wx * vx + wy * vy) / (vlen * vlen)
    sd = (wx * vy - wy * vx).abs() / vlen
    hit = (0 < ss) & (ss < 1) & (sd < r)
    return torch.minimum(x, torch.where(hit, _sens((dp - r) / (dp - sd)), 1.))


def _frame(angles, p, sign):
    a = math.pi / 180 * angles
    c, s = torch.cos(a), torch.sin(a)
    x, y = p[..., 0], p[..., 1]
    return torch.stack(torch.broadcast_tensors(c * x - sign * s * y, sign * s * x + c * y), -1)


def move(world, agents, actions, fps=10., accel=5., ang_accel=180., decay=.125):
    """Momentum movement then the collision-resolved physics step.

    :param actions: (N, A) ints in [0, 7).
    :return: ``(agents, progress)``.
    """
    dtype, dev = agents['positions'].dtype, agents['positions'].device
    dv = torch.as_tensor(accel / fps * VELOCITY_BASIS, dtype=torch.float32,
                         device=dev).to(dtype)[actions.long()]
    dw = torch.as_tensor(ang_accel / fps * ANGVELOCITY_BASIS, dtype=torch.float32,
                         device=dev).to(dtype)[actions.long()]
    angvel = (1 - decay) * agents['angvelocity'] + dw
    vel = (1 - decay) * agents['velocity'] + _frame(agents['angles'], dv, +1)
    pos, r = agents['positions'], AGENT_RADIUS
    u = torch.div(vel, torch.full((), fps, dtype=dtype, device=dev))
    N, A = pos.shape[:2]
    x = torch.ones((N, A), dtype=dtype, device=dev)
    if A > 1:
        pair = _disc_disc(pos[:, :, None], u[:, :, None], pos[:, None], u[:, None],
                          1.001 * 2. * r)
        off = ~torch.eye(A, dtype=torch.bool, device=dev)[None]
        x = torch.where(off, pair, 1.).amin(2)
    nd = world['n_dynamic']
    walls = world['lines'][:, nd:]
    live = (nd + torch.arange(walls.shape[1], device=dev))[None] < world['lines_width'][:, None]
    per = _disc_line(pos[:, :, None, 0], pos[:, :, None, 1], u[:, :, None, 0],
                     u[:, :, None, 1], walls[:, None, :, 0, 0], walls[:, None, :, 0, 1],
                     walls[:, None, :, 1, 0], walls[:, None, :, 1, 1], 1.001 * r)
    progress = torch.minimum(x, torch.where(live[:, None], per, 1.).amin(2))
    hit = progress < 1
    fps_t = torch.full((), fps, dtype=dtype, device=dev)
    angles = agents['angles'] + torch.div(progress * angvel, fps_t)
    return dict(angles=((angles % 360.) + 180.) % 360. - 180.,
                positions=pos + torch.div(progress[..., None] * vel, fps_t),
                angvelocity=torch.where(hit, 0., angvel),
                velocity=torch.where(hit[..., None], 0., vel)), progress


def respawn(world, agents, reset, choices):
    """Agents under ``reset`` (N, A) moved to spawn slot ``choices`` (N, A),
    facing its angle, at rest."""
    c = choices.long()
    ang = torch.gather(world['spawn_angles'], -1, c[..., None])[..., 0]
    pos = torch.gather(world['spawn_positions'], -2,
                       c[..., None, None].expand(*c.shape, 1, 2))[..., 0, :]
    return dict(angles=torch.where(reset, ang, agents['angles']),
                positions=torch.where(reset[..., None], pos, agents['positions']),
                angvelocity=torch.where(reset, 0., agents['angvelocity']),
                velocity=torch.where(reset[..., None], 0., agents['velocity']))


# --- sight -----------------------------------------------------------------

def place(model, angles, positions):
    """Each agent's model lines at its pose, (N, A·M, 2, 2)."""
    d = _frame(angles[..., None, None], model, +1) + positions[:, :, None, None, :]
    return d.reshape(d.shape[0], -1, 2, 2)


def raycast(lines, lines_width, angles, positions, res, hsw, radius):
    """Nearest hit of every (env, agent, ray): the lowest-index line within
    ``Z_TOLERANCE`` of the nearest. Returns ``indices`` (-1 on a miss),
    ``locations`` along the line, ``dots`` and ``distances``, each (N, A, R)."""
    dtype, dev = positions.dtype, positions.device
    L = lines.shape[1]
    y = torch.div(res - 2 * torch.arange(res, dtype=dtype, device=dev) - 1,
                  torch.full((), res, dtype=dtype, device=dev))
    a = math.pi / 180 * angles
    c, s = torch.cos(a)[..., None], torch.sin(a)[..., None]
    uy = hsw * y
    rux, ruy = c - s * uy, s + c * uy
    rlen = torch.sqrt(rux * rux + ruy * ruy)
    near = torch.div(torch.full((), radius, dtype=dtype, device=dev), rlen)
    ax, ay = lines[:, None, None, :, 0, 0], lines[:, None, None, :, 0, 1]
    vx, vy = lines[:, None, None, :, 1, 0] - ax, lines[:, None, None, :, 1, 1] - ay
    pqx, pqy = ax - positions[:, :, None, None, 0], ay - positions[:, :, None, None, 1]
    rx, ry = rux[..., None], ruy[..., None]
    uxv = vy * rx - vx * ry
    sq, tq = (pqx * vy - pqy * vx) / uxv, (pqx * ry - pqy * rx) / uxv
    live = torch.arange(L, device=dev) < lines_width[:, None, None, None]
    valid = ~(uxv.abs() < PARALLEL_EPS) & (0 <= tq) & (tq <= 1) & (near[..., None] < sq) & live
    sm = torch.where(valid, sq, math.inf)
    eligible = sm < (sm.amin(-1) + Z_TOLERANCE)[..., None]
    idx = eligible.int().argmax(-1)
    found = eligible.any(-1)

    def pick(q):
        return torch.gather(q.expand(eligible.shape), -1, idx[..., None].long())[..., 0]

    svx, svy = pick(vx), pick(vy)
    dots = (rux * svx + ruy * svy) / (rlen * torch.sqrt(svx * svx + svy * svy) + 1e-6)
    return dict(indices=torch.where(found, idx.int(), -1),
                locations=torch.where(found, pick(tq), math.nan),
                dots=torch.where(found, dots, math.nan),
                distances=torch.where(found, pick(sq), math.inf) * rlen)


def _per_env(arr, idx):
    N = arr.shape[0]
    flat = idx.reshape(N, -1).long()
    if arr.ndim == 3:
        return torch.gather(arr, 1, flat[..., None].expand(-1, -1, arr.shape[-1])).reshape(
            *idx.shape, arr.shape[-1])
    return torch.gather(arr, 1, flat).reshape(idx.shape)


def shade(starts, widths, colors, light, rc):
    """Linear-RGB colour of every ray, (N, A, R, 3): the two nearest texels of
    the hit, weighted, times their light and the Lambert factor; misses black."""
    hit = rc['indices'] >= 0
    idx = torch.clamp(rc['indices'], min=0)
    loc = torch.where(hit, rc['locations'], .5)
    w = _per_env(widths, idx).to(loc.dtype)
    y = torch.minimum(loc * (w + 1), w - 1)
    l = torch.clamp(y - 1, min=0.).int()
    r = torch.minimum(y, w - 1).int()
    ld, rd = (y - (l + 1)).abs() + 1e-3, (y - (r + 1)).abs() + 1e-3
    lw, rw = rd / (ld + rd), ld / (ld + rd)
    start = _per_env(starts, idx)
    intensity = lw * _per_env(light, start + l) + rw * _per_env(light, start + r)
    color = lw[..., None] * _per_env(colors, start + l) + rw[..., None] * _per_env(colors, start + r)
    lambert = 1 - torch.where(hit, rc['dots'], 0.)**2
    return torch.where(hit[..., None], (lambert * intensity)[..., None] * color, 0.)


def seen_texels(rc, starts, widths, T):
    """Per env, the texels that some hit ray lands on, (N, T) bool."""
    N = rc['indices'].shape[0]
    line = rc['indices'].reshape(N, -1)
    hit = line >= 0
    l0 = torch.clamp(line, min=0).long()
    s, w = torch.gather(starts, 1, l0), torch.gather(widths, 1, l0)
    loc = torch.where(hit, rc['locations'].reshape(N, -1), 0.)
    ti = torch.minimum(torch.floor(w * loc), w - 1).int()
    seen = torch.zeros((N, T + 1), dtype=torch.bool, device=line.device)
    seen.scatter_(1, torch.where(hit, s + torch.clamp(ti, min=0), T).long(), True)
    return seen[:, :T]


def pool(world, rc, screen):
    """RGB (N, A, 3, 1, R/s) and depth (N, A, 1, 1, R/s), means over ``s`` rays."""
    s = world['subsample']
    rgb = screen.permute(0, 1, 3, 2)
    rgb = rgb.reshape(*rgb.shape[:-1], -1, s).mean(-1)[:, :, :, None, :]
    depth = 1 - torch.clamp(torch.div(rc['distances'] - AGENT_RADIUS,
                                      torch.full((), 10., dtype=screen.dtype,
                                                 device=screen.device)), 0, 1)
    d = depth.reshape(*depth.shape[:-1], -1, s).mean(-1)[:, :, None, None, :]
    return rgb, d


def imu(agents):
    dev, dtype = agents['angles'].device, agents['angles'].dtype
    full = lambda x: torch.full((), x, dtype=dtype, device=dev)
    return torch.cat([torch.div(agents['angvelocity'][..., None], full(360.)),
                      torch.div(_frame(agents['angles'], agents['velocity'], -1), full(10.))], -1)


# --- the two envs' steps, on a block of envs ---------------------------------

def explorer_observe(world, agents, seen0, reset):
    """Raycast past the agent's own model, shade, pool; the seen texels and
    the reward per newly seen texel (zero where the env reset)."""
    nd = world['n_dynamic']
    rc = raycast(world['lines'][:, nd:], world['lines_width'] - nd, agents['angles'],
                 agents['positions'], world['res'], world['half_screen_width'], AGENT_RADIUS)
    rc['indices'] = torch.where(rc['indices'] >= 0, rc['indices'] + nd, -1)
    screen = shade(world['line_tex_starts'], world['line_tex_widths'], world['textures'],
                   world['baked'], rc)
    rgb, d = pool(world, rc, screen)
    seen = seen0 | seen_texels(rc, world['line_tex_starts'], world['line_tex_widths'],
                               world['tex_line'].shape[1])
    potential = seen.sum(-1).to(rgb.dtype)
    old = seen0.sum(-1).to(rgb.dtype)
    reward = torch.div(potential - old, torch.full((), world['res'] // world['subsample'],
                                                   dtype=rgb.dtype, device=rgb.device))
    reward = torch.where(reset, 0., reward)
    return dict(rgb=rgb, d=d, imu=imu(agents)), seen, potential, reward, rc


def explorer_reset(world, choices):
    N = world['lines'].shape[0]
    dtype, dev = world['lines'].dtype, world['lines'].device
    zeros = lambda *s: torch.zeros(s, dtype=dtype, device=dev)
    agents = dict(angles=zeros(N, 1), positions=zeros(N, 1, 2), angvelocity=zeros(N, 1),
                  velocity=zeros(N, 1, 2))
    agents = respawn(world, agents, torch.ones((N, 1), dtype=torch.bool, device=dev), choices)
    reset = torch.ones(N, dtype=torch.bool, device=dev)
    seen0 = torch.zeros(world['tex_line'].shape, dtype=torch.bool, device=dev)
    obs, seen, potential, reward, _ = explorer_observe(world, agents, seen0, reset)
    state = dict(agents=agents, progress=torch.ones((N, 1), dtype=dtype, device=dev),
                 seen=seen, potential=potential,
                 lengths=torch.zeros(N, dtype=torch.int32, device=dev))
    return state, dict(obs=obs, reward=reward, reset=reset)


def explorer_step(world, state, actions, choices):
    """:param actions: (N, 1). :param choices: (N, 1) spawn slots."""
    agents, progress = move(world, state['agents'], actions)
    lengths = state['lengths'] + 1
    reset = lengths >= state['potential'] + 200
    agents = respawn(world, agents, reset[:, None], choices)
    seen = torch.where(reset[:, None], False, state['seen'])
    lengths = torch.where(reset, 0, lengths)
    obs, seen, potential, reward, rc = explorer_observe(world, agents, seen, reset)
    state = dict(agents=agents, progress=progress, seen=seen, potential=potential,
                 lengths=lengths)
    return state, dict(obs=obs, reward=reward, reset=reset), rc


def _deathmatch_observe(world, agents, health, damage):
    """Draw the models, re-light their texels, raycast, shade, pool, shoot."""
    N, A = health.shape
    dtype, dev = world['lines'].dtype, world['lines'].device
    nd = world['n_dynamic']
    dyn = place(world['model'], agents['angles'], agents['positions'])
    walls = world['lines'][:, nd:]
    # The model texels' light this frame, the static walls occluding.
    C = texel_points(dyn, world['tex_line'], world['line_tex_starts'][:, :nd],
                     world['line_tex_widths'][:, :nd], 0, world['n_dynamic_texels'])
    k = world['k_lights']
    light = world['baked'].clone()
    light[:, :world['n_dynamic_texels']] = intensity_at(
        C, walls, world['lines_width'] - nd, world['lights'][:, :k], world['lights_width'])
    rc = raycast(torch.cat([dyn, walls], 1), world['lines_width'], agents['angles'],
                 agents['positions'], world['res'], world['half_screen_width'], AGENT_RADIUS)
    screen = shade(world['line_tex_starts'], world['line_tex_widths'], world['textures'],
                   light, rc)
    rgb, d = pool(world, rc, screen)

    # Shoot: the opponent ids that the middle two pooled columns show.
    s, R = world['subsample'], world['res']
    r0 = s * (R // s // 2 - 1) + s // 2
    mid = rc['indices'][..., r0:r0 + s + 1:s][:, :, None]
    obj = torch.div(mid, len(world['model']), rounding_mode='floor')
    opponents = torch.where((0 <= mid) & (obj < A), obj, -1)
    ids = torch.arange(A, device=dev)
    matchings = (opponents[:, :, None] == ids[None, None, :, None, None]).any(-1).any(-1)
    hits = matchings.sum(2).to(dtype)
    wounds = matchings.sum(1).to(dtype)
    damage = damage + .05 * hits
    pos = agents['positions']
    outside = ((pos < -1.).any(-1) | (pos > (world['bounds'][:, None] + 1.)).any(-1))
    health = health - .05 * (wounds + outside) - .001
    obs = dict(rgb=rgb, d=d, imu=imu(agents), health=health[..., None])
    obs = {k: v.reshape(N * A, 1, *v.shape[2:]) for k, v in obs.items()}
    return obs, health, damage, matchings, hits.reshape(-1), rc


def deathmatch_reset(world, choices):
    """:param choices: (N, A) spawn slots."""
    N, A = choices.shape
    dtype, dev = world['lines'].dtype, world['lines'].device
    zeros = lambda *s: torch.zeros(s, dtype=dtype, device=dev)
    agents = dict(angles=zeros(N, A), positions=zeros(N, A, 2), angvelocity=zeros(N, A),
                  velocity=zeros(N, A, 2))
    reset = torch.ones((N, A), dtype=torch.bool, device=dev)
    agents = respawn(world, agents, reset, choices)
    obs, health, damage, matchings, hits, _ = _deathmatch_observe(
        world, agents, torch.ones((N, A), dtype=dtype, device=dev), zeros(N, A))
    state = dict(agents=agents, progress=torch.ones((N, A), dtype=dtype, device=dev),
                 health=health, damage=damage, matchings=matchings)
    return state, dict(obs=obs, reward=hits, reset=reset.reshape(-1))


def deathmatch_step(world, state, actions, choices):
    """:param actions: (N·A, 1) in the agent-as-env layout. :param choices:
    (N, A) spawn slots. Returns the state and the world in the agent-as-env
    layout, as the env does."""
    N, A = state['health'].shape
    reset = state['health'] <= 0
    agents = respawn(world, state['agents'], reset, choices)
    health = torch.where(reset, 1., state['health'])
    damage = torch.where(reset, 0., state['damage'])
    agents, progress = move(world, agents, actions.reshape(N, A))
    obs, health, damage, matchings, hits, rc = _deathmatch_observe(world, agents, health,
                                                                   damage)
    state = dict(agents=agents, progress=progress, health=health, damage=damage,
                 matchings=matchings)
    return state, dict(obs=obs, reward=hits, reset=reset.reshape(-1)), rc
