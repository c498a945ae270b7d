"""The 1-D raycast renderer: draw, raycast, shade — the port's ground truth.

Counterpart of :mod:`megastep_tpu.ops.render` (the reference's draw, raycast and
shader kernels, ``kernels.cu:297-475``), as torch ops over the whole (env, agent,
pixel) batch. The observe kernel (``csrc/observe.cu``) is held against these
functions.

Nearest-hit semantics are the JAX package's: take the minimum hit distance, then
the *lowest-indexed* line within ``Z_TOLERANCE`` of it. (The reference CUDA scan
replaces the incumbent only when a hit is closer by more than the tolerance; the
two differ only on chains of 3+ mutually-within-tolerance lines.)

The arithmetic follows the fused kernel's op order (``uxv = vy·rux − vx·ruy``,
``t_num = pqx·ruy − pqy·rux``, ``s_num = pqx·vy − pqy·vx``, true divisions), and
every op is one elementwise torch op, so the CUDA kernel, built without FMA
contraction, computes the same bits.
"""
import math

import torch

from ..arrdict import arrdict
from . import bake
from .geom import div, rotate

Z_TOLERANCE = 1e-4
PARALLEL_EPS = 1e-3


def ray_y(res, device='cpu', dtype=torch.float32):
    """Screen-space y coordinate of each of the ``res`` rays before FOV scaling
    (``kernels.cu:234-236`` without the half-screen factor)."""
    r = torch.arange(res, dtype=dtype, device=device)
    return div(res - 2 * r - 1, res)


def place(model, angles, positions):
    """Agent-model lines rotated by each agent's angle and moved to its position
    (``draw_kernel``'s arithmetic, ``kernels.cu:297-318``): endpoints as
    ``(c·x − s·y) + px``, ``(s·x + c·y) + py``.

    :param model: (M, 2, 2) one model for every agent, or (N, A, M, 2, 2) one
        per agent.
    :param angles: (N, A) degrees. :param positions: (N, A, 2) meters.
    :return: (N, A·M, 2, 2), agent ``a``'s lines at slots ``a·M`` to ``a·M + M``.
    """
    dyn = rotate(angles[..., None, None], model) + positions[:, :, None, None, :]
    return dyn.reshape(dyn.shape[0], -1, 2, 2)


def draw_dynamic(scenery, agents):
    """Just the rotated+translated agent-model lines, (N, n_dynamic, 2, 2): the
    part of :func:`draw` that the dynamic re-bake needs."""
    return place(scenery.model, agents.angles, agents.positions)


def draw(scenery, agents):
    """The line array with the rotated+translated agent models written into the
    dynamic head slots (``draw_kernel``, ``kernels.cu:297-318``). Returns a new
    (N, L, 2, 2) tensor; the scenery is untouched."""
    return torch.cat([draw_dynamic(scenery, agents),
                      scenery.lines[:, scenery.n_dynamic:]], 1)


def pose_basis(angles):
    """cos and sin of each pose angle, in degrees: (N, A) each. The observe
    kernel computes the same f32 product and takes cosf/sinf of it."""
    a = math.pi / 180 * angles
    return torch.cos(a), torch.sin(a)


def ray_directions(angles, res, half_screen_width):
    """Global-frame ray directions of every (env, agent, pixel): ``(rux, ruy)``,
    each (N, A, R)."""
    uy = half_screen_width * ray_y(res, angles.device)                    # (R,)
    c, s = (x[..., None] for x in pose_basis(angles))                     # (N, A, 1)
    return c - s * uy, s + c * uy


def intersections(lines_now, lines_width, angles, positions, res,
                  half_screen_width, agent_radius, fast_div=False):
    """Every (env, agent, pixel) ray against every line: the hit fractions ``s``
    (along the ray) and ``t`` (along the line), and ``valid``, whether the ray
    hits the line in front of the near plane — each (N, A, R, L) — plus the ray
    directions ``rux``, ``ruy`` and their lengths ``rlen``, each (N, A, R).

    ``s`` and ``t`` are junk (inf or NaN) where ``valid`` is False for a
    near-parallel line.

    :param fast_div: the observe kernel's opt-in mode (``fused.py:307-313`` in
        the JAX package): one true division ``1 / uxv`` shared by two products,
        in place of the two quotients. About an ulp off them, so it can flip a
        winner on the tolerance edge.
    """
    L = lines_now.shape[1]
    rux, ruy = ray_directions(angles, res, half_screen_width)             # (N, A, R)
    rlen = torch.sqrt(rux * rux + ruy * ruy)
    near = div(agent_radius, rlen)

    ax = lines_now[:, None, None, :, 0, 0]                                # (N,1,1,L)
    ay = lines_now[:, None, None, :, 0, 1]
    vx = lines_now[:, None, None, :, 1, 0] - ax
    vy = lines_now[:, None, None, :, 1, 1] - ay
    pqx = ax - positions[:, :, None, None, 0]                             # (N,A,1,L)
    pqy = ay - positions[:, :, None, None, 1]
    s_num = pqx * vy - pqy * vx
    rx, ry = rux[..., None], ruy[..., None]                               # (N,A,R,1)
    uxv = vy * rx - vx * ry                                               # (N,A,R,L)
    t_num = pqx * ry - pqy * rx

    distant = uxv.abs() < PARALLEL_EPS
    if fast_div:
        recip = div(1., uxv)
        sq, tq = s_num * recip, t_num * recip
    else:
        sq, tq = s_num / uxv, t_num / uxv
    live = (torch.arange(L, device=lines_now.device)
            < lines_width[:, None, None, None])
    valid = ~distant & (0 <= tq) & (tq <= 1) & (near[..., None] < sq) & live
    return arrdict(s=sq, t=tq, valid=valid, vx=vx, vy=vy, rux=rux, ruy=ruy,
                   rlen=rlen)


def raycast(lines_now, lines_width, angles, positions, res, half_screen_width,
            agent_radius, fast_div=False):
    """Nearest-hit raycast of every (env, agent, pixel) against every line
    (``raycast_kernel``, ``kernels.cu:326-383``).

    Materializes (N, A, R, L) intermediates: about 100 MB each at 2,048 envs,
    res 256 and 48 lines.

    :return: arrdict with ``indices`` (line id or -1), ``locations`` (hit fraction
        along the line, NaN if none), ``dots`` (normalized ray·line, NaN if none),
        ``distances`` (meters, +inf if none) — all (N, A, R).
    :param fast_div: see :func:`intersections`.
    """
    x = intersections(lines_now, lines_width, angles, positions, res,
                      half_screen_width, agent_radius, fast_div)
    s_masked = torch.where(x.valid, x.s, math.inf)
    s_min = s_masked.amin(-1)                                             # (N, A, R)
    eligible = s_masked < (s_min + Z_TOLERANCE)[..., None]
    idx = eligible.int().argmax(-1)                                       # first eligible
    found = eligible.any(-1)

    def select(q):
        return torch.gather(q.expand(eligible.shape), -1, idx[..., None].long())[..., 0]

    s_sel = select(x.s)
    t_sel = select(x.t)
    sel_vx = select(x.vx)
    sel_vy = select(x.vy)
    sel_vlen = torch.sqrt(sel_vx * sel_vx + sel_vy * sel_vy)
    dot_sel = (x.rux * sel_vx + x.ruy * sel_vy) / (x.rlen * sel_vlen + 1e-6)

    return arrdict(
        indices=torch.where(found, idx.int(), -1),
        locations=torch.where(found, t_sel, math.nan),
        dots=torch.where(found, dot_sel, math.nan),
        distances=torch.where(found, s_sel, math.inf) * x.rlen)


def tex_filter(loc, width):
    """The reference's two-tap linear texture filter (``kernels.cu:394-405``).

    :return: (l, r, lw, rw) — integer texel offsets within the line and their weights.
    """
    w = width.to(loc.dtype)
    y = torch.minimum(loc * (w + 1), w - 1)
    l = torch.clamp(y - 1, min=0.).int()
    r = torch.minimum(y, w - 1).int()
    ld = (y - (l + 1)).abs() + 1e-3
    rd = (y - (r + 1)).abs() + 1e-3
    return l, r, rd / (ld + rd), ld / (ld + rd)


def _gather_per_env(arr, idx):
    """``arr[n, idx[n, ...]]`` for (N, T[, C]) arr and (N, ...) idx."""
    N = arr.shape[0]
    flat = idx.reshape(N, -1).long()
    if arr.ndim == 3:
        out = torch.gather(arr, 1, flat[..., None].expand(-1, -1, arr.shape[-1]))
        return out.reshape(*idx.shape, arr.shape[-1])
    return torch.gather(arr, 1, flat).reshape(idx.shape)


def shade_table(line_tex_starts, line_tex_widths, table, rc):
    """:func:`shade` over a packed (N, T, 4) ``[r, g, b, baked]`` texel table —
    the form the observe kernel reads. Returns the (N, A, R, 3) screen."""
    hit = rc.indices >= 0
    idx = torch.clamp(rc.indices, min=0)
    loc = torch.where(hit, rc.locations, .5)
    width = _gather_per_env(line_tex_widths, idx)
    start = _gather_per_env(line_tex_starts, idx)
    l, r, lw, rw = tex_filter(loc, width)
    tap_l = _gather_per_env(table, start + l)                             # (N, A, R, 4)
    tap_r = _gather_per_env(table, start + r)
    intensity = lw * tap_l[..., 3] + rw * tap_r[..., 3]

    lambert = 1 - torch.where(hit, rc.dots, 0.)**2
    shadefac = (lambert * intensity)[..., None]
    color = lw[..., None] * tap_l[..., :3] + rw[..., None] * tap_r[..., :3]
    return torch.where(hit[..., None], shadefac * color, 0.)


def pack_table(scenery, baked=None):
    """The (N, T, 4) ``[r, g, b, baked]`` texel table, one 16-byte row per texel."""
    baked = scenery.baked if baked is None else baked
    return torch.cat([scenery.textures, baked[..., None]], -1).contiguous()


def shade(scenery, rc, baked_now):
    """Texture lookup + lighting + Lambert shading per pixel (``shader_kernel``,
    ``kernels.cu:407-450``), through gathers. Returns the (N, A, R, 3) linear-RGB
    screen; misses are black."""
    return shade_table(scenery.line_tex_starts, scenery.line_tex_widths,
                       pack_table(scenery, baked_now), rc)


def render(scenery, agents, res, half_screen_width, agent_radius,
           rebake_dynamic=None):
    """Full render pass: draw agent models, raycast, re-light the dynamic texels,
    shade (counterpart of ``megastep_tpu.ops.render.render``).

    :param rebake_dynamic: whether to re-bake the live lighting of the
        agent-model texels this frame. Defaults to ``n_agents > 1``: with a
        single agent the camera's near plane hides its own model, so that
        lighting is never sampled.
    :return: arrdict of ``indices/locations/dots/distances`` (N, A, R) and
        ``screen`` (N, A, R, 3).
    """
    lines_now = draw(scenery, agents)
    rc = raycast(lines_now, scenery.lines_width, agents.angles,
                 agents.positions, res, half_screen_width, agent_radius)
    if rebake_dynamic is None:
        rebake_dynamic = scenery.n_agents > 1
    baked_now = scenery.baked
    if rebake_dynamic:
        dyn = bake.dynamic_texel_intensity(scenery, lines_now)
        baked_now = torch.cat([dyn, baked_now[:, scenery.n_dynamic_texels:]], 1)
    rc['screen'] = shade(scenery, rc, baked_now)
    return rc
