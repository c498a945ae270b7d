"""Light baking: per-texel illumination with hard shadows.

Counterpart of :mod:`megastep_tpu.ops.bake` (the reference baking kernel and
``light_intensity``, ``kernels.cu:232-293``): each texel center accumulates
``LUMINANCE * intensity / max(d^2, 1)`` from every light that has unobstructed
line-of-sight (occlusion tested against *static* lines only), plus 0.1 ambient,
clamped to 1. Runs as torch ops on the scenery's device.

Two uses:
  * :func:`bake`, the static bake, once at scene build;
  * :func:`dynamic_texel_intensity`, the per-frame re-bake of the agent-model
    texels (the first ``n_dynamic_texels`` of every env) from this frame's drawn
    models, which gives moving agents live lighting (Deathmatch).
"""
import numpy as np
import torch

from .. import constants
from . import geom
from .geom import div


def texel_points(lines, tex_line, line_tex_starts, line_tex_widths, t0, T,
                 l_max=None):
    """World coordinates of texel centers ``t0 : t0+T`` for every env (the JAX
    package's gather path).

    :param lines: (N, L, 2, 2) line array to read geometry from.
    :param tex_line: (N, Tmax) owning line of each texel.
    :param l_max: a bound on the owning-line index of the requested texels
        (all ``tex_line[:, t0:t0+T] < l_max``). The dynamic re-bake passes
        ``n_dynamic`` with just the drawn agent-model lines.
    :return: (N, T, 2) texel centers.
    """
    if l_max is not None:
        lines = lines[:, :l_max]
        line_tex_starts = line_tex_starts[:, :l_max]
        line_tex_widths = line_tex_widths[:, :l_max]
    tl = tex_line[:, t0:t0 + T].long()                                    # (N, T)
    starts = torch.gather(line_tex_starts, 1, tl)
    widths = torch.gather(line_tex_widths, 1, tl)
    ends = lines.reshape(*lines.shape[:2], 4)
    ab = torch.gather(ends, 1, tl[..., None].expand(-1, -1, 4))           # (N, T, 4)
    a, b = ab[..., 0:2], ab[..., 2:4]
    t_idx = t0 + torch.arange(T, dtype=torch.int32, device=lines.device)[None]
    loc = div(t_idx - starts + .5, torch.clamp(widths, min=1).float())
    return a * (1 - loc[..., None]) + b * loc[..., None]


def intensity_at(points, lines, lines_width, n_dynamic, lights, lights_width,
                 chunk=64):
    """Light intensity at each query point, with hard-shadow occlusion.

    :param points: (N, P, 2) query points.
    :param lines: (N, L, 2, 2); only slots ``n_dynamic <= l < lines_width`` occlude.
    :param lights: (N, K, 3) — x, y, intensity.
    :param chunk: lines tested per pass, bounding the (N, P, K, chunk) occlusion
        intermediates.
    :return: (N, P) intensities in [0, 1].
    """
    N, P, _ = points.shape
    K = lights.shape[1]
    L = lines.shape[1]
    dev = points.device

    Ix = lights[:, None, :, 0]                                            # (N, 1, K)
    Iy = lights[:, None, :, 1]
    Ii = lights[:, None, :, 2]
    Cx = points[:, :, None, 0]                                            # (N, P, 1)
    Cy = points[:, :, None, 1]
    Ux = (Cx - Ix)[..., None]                                             # (N, P, K, 1)
    Uy = (Cy - Iy)[..., None]

    light_live = torch.arange(K, device=dev)[None, None] < lights_width[:, None, None]

    obstructed = torch.zeros((N, P, K), dtype=torch.bool, device=dev)
    for c0 in range(0, L, chunk):
        seg = lines[:, c0:c0 + chunk]
        ax = seg[:, None, None, :, 0, 0]                                  # (N,1,1,c)
        ay = seg[:, None, None, :, 0, 1]
        vx = seg[:, None, None, :, 1, 0] - ax
        vy = seg[:, None, None, :, 1, 1] - ay
        # geom.intersect(I, U, a, v), planar over (N, P, K, c).
        uxv = Ux * vy - Uy * vx
        pqx = ax - Ix[..., None]
        pqy = ay - Iy[..., None]
        distant = uxv.abs() < geom.PARALLEL_EPS
        safe = torch.where(distant, 1., uxv)
        s = torch.where(distant, np.inf, (pqx * vy - pqy * vx) / safe)
        t = torch.where(distant, np.inf, (pqx * Uy - pqy * Ux) / safe)
        l_idx = c0 + torch.arange(seg.shape[1], device=dev)
        static = (l_idx >= n_dynamic) & (l_idx < lines_width[:, None])    # (N, c)
        blocked = (t > 0.) & (t < 1.) & (s > 0.) & (s < .999) & static[:, None, None]
        obstructed |= blocked.any(-1)

    d2 = (Ix - Cx)**2 + (Iy - Cy)**2                                      # (N, P, K)
    contrib = constants.LUMINANCE * Ii / torch.clamp(d2, min=1.)
    lit = ~obstructed & light_live
    total = constants.AMBIENT + torch.where(lit, contrib, 0.).sum(-1)
    return torch.clamp(total, max=1.)


def bake(scenery, env_chunk=512, tex_chunk=512):
    """Bakes static illumination into ``scenery.baked``, in (env, texel) chunks so
    peak device memory stays bounded at any env count. Padded texels keep the
    reference's initialize-to-ones convention.

    :return: a new :class:`~megastep_tpu_torch.scene.Scenery`.
    """
    N, Tmax = scenery.baked.shape
    baked = torch.ones((N, Tmax), dtype=torch.float32, device=scenery.baked.device)
    for n0 in range(0, N, env_chunk):
        n1 = min(n0 + env_chunk, N)
        for t0 in range(0, Tmax, tex_chunk):
            T = min(tex_chunk, Tmax - t0)
            C = texel_points(scenery.lines[n0:n1], scenery.tex_line[n0:n1],
                             scenery.line_tex_starts[n0:n1],
                             scenery.line_tex_widths[n0:n1], t0, T)
            baked[n0:n1, t0:t0 + T] = intensity_at(
                C, scenery.lines[n0:n1], scenery.lines_width[n0:n1],
                scenery.n_dynamic, scenery.lights[n0:n1],
                scenery.lights_width[n0:n1])
    mask = (torch.arange(Tmax, device=baked.device)[None]
            < scenery.tex_width[:, None])
    return scenery.replace(baked=torch.where(mask, baked, 1.))


def dynamic_texel_intensity(scenery, lines_now, k_max=None):
    """Live illumination of the dynamic (agent-model) texels, given this frame's
    drawn line array. Returns (N, n_dynamic_texels).

    :param k_max: a bound on the per-env light count (the true maximum, known at
        env build); the padded light slots past it are left out.
    """
    nd = scenery.n_dynamic
    return dynamic_texel_intensity_parts(
        scenery, lines_now[:, :nd], lines_now[:, nd:], k_max=k_max)


def dynamic_texel_intensity_parts(scenery, dyn_lines, walls, k_max=None):
    """:func:`dynamic_texel_intensity` with the line array given in two parts:
    the drawn agent models (``(N, n_dynamic, 2, 2)``,
    :func:`megastep_tpu_torch.ops.render.draw_dynamic`) and the static walls
    (``scenery.lines[:, n_dynamic:]``, which the draw never touches). Dynamic
    texels lie on the model lines, and only the walls occlude."""
    nd = scenery.n_dynamic
    C = texel_points(dyn_lines, scenery.tex_line, scenery.line_tex_starts,
                     scenery.line_tex_widths, 0, scenery.n_dynamic_texels, l_max=nd)
    lights = scenery.lights if k_max is None else scenery.lights[:, :k_max]
    return intensity_at(C, walls, scenery.lines_width - nd, 0, lights,
                        scenery.lights_width)
