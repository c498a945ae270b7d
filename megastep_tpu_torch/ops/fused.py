"""The fused observe: raycast + shade (+ seen-texel mask) in one CUDA kernel.

Counterpart of :mod:`megastep_tpu.ops.fused`. The JAX package's Pallas kernel
(``_observe_kernel``) becomes ``csrc/observe.cu``, hand-written for Hopper; this
module holds its wrapper, :func:`observe`, and its plain torch version,
:func:`observe_plain`, which the CPU tests use and the kernel is held against on
the card.

Every mode of the JAX kernel is ported: the Explorer mode (``want_seen``,
``skip_dyn``), Deathmatch's per-frame intensities of the agent-model texels
(``baked_dyn``, the JAX ``table_patch``), the in-kernel draw (``draw_model``) and
the shared reciprocal (``fast_div``). The TPU layouts of the JAX kernel (the
three-way bf16 table split, the blocked ``table8`` and its hierarchical one-hots
and patch rows, the env-block unroll, size buckets) are not carried over: Hopper
gathers texels directly from an (N, T, 4) f32 table
(:func:`megastep_tpu_torch.ops.render.pack_table`).

The same library holds Deathmatch's per-frame re-bake of the agent-model
texels as a second kernel (:func:`rebake`), whose plain version is
:func:`megastep_tpu_torch.ops.bake.dynamic_texel_intensity_parts`. It replaces
no Pallas kernel: the JAX package's re-bake is XLA ops.
"""
import ctypes

import torch

from .. import kernels, tracing
from ..arrdict import arrdict
from . import bake, render


def seen_mask(rc, tex_starts, tex_widths, T):
    """Per-env mask of the texels the hit rays see (the reference's
    ``explorer.py:34-48``): texel ``start + clamp(floor(width * t), 0, width - 1)``
    of each hit ray's line. Misses mark nothing.

    :return: (N, T) bool.
    """
    N = rc.indices.shape[0]
    line = rc.indices.reshape(N, -1)
    hit = line >= 0
    line0 = torch.clamp(line, min=0).long()
    start = torch.gather(tex_starts, 1, line0)
    width = torch.gather(tex_widths, 1, line0)
    loc = torch.where(hit, rc.locations.reshape(N, -1), 0.)
    ti = torch.minimum(torch.floor(width * loc), width - 1).int()
    tex = start + torch.clamp(ti, min=0)
    # Misses go to a spare column T, sliced off below.
    seen = torch.zeros((N, T + 1), dtype=torch.bool, device=line.device)
    seen.scatter_(1, torch.where(hit, tex, T).long(), True)
    return seen[:, :T]


def _check_modes(skip_dyn, draw_model):
    if skip_dyn and draw_model:
        raise ValueError('skip_dyn slices off the very slots draw_model would '
                         'draw into')


def observe_plain(lines, lines_width, tex_starts, tex_widths, table, angles,
                  positions, res, half_screen_width, agent_radius, want_seen=True,
                  skip_dyn=0, baked_dyn=None, draw_model=0, fast_div=False):
    """:func:`observe` as torch ops: :func:`render.place` of the model slots (if
    ``draw_model``), :func:`render.raycast` over the line slots from ``skip_dyn``
    on, :func:`render.shade_table` through gathers over the table with
    ``baked_dyn`` written in, then :func:`seen_mask` (if ``want_seen``).
    Materializes (N, A, R, L) raycast intermediates."""
    _check_modes(skip_dyn, draw_model)
    if draw_model:
        N, A = angles.shape
        n = A * draw_model
        head = lines[:, :n].reshape(N, A, draw_model, 2, 2)
        lines = torch.cat([render.place(head, angles, positions), lines[:, n:]], 1)
    rc = render.raycast(lines[:, skip_dyn:], lines_width - skip_dyn, angles,
                        positions, res, half_screen_width, agent_radius, fast_div)
    hit = rc.indices >= 0
    rc['indices'] = torch.where(hit, rc.indices + skip_dyn, -1)
    if baked_dyn is not None:
        table = table.clone()
        table[:, :baked_dyn.shape[1], 3] = baked_dyn
    screen = render.shade_table(tex_starts, tex_widths, table, rc)
    out = arrdict(indices=rc.indices, distances=rc.distances,
                  screen=screen.permute(0, 1, 3, 2).contiguous())
    if want_seen:
        out['seen'] = seen_mask(rc, tex_starts, tex_widths, table.shape[1])
    return out


#: Shared memory per staged line slot: the float4 (pqx, pqy, vx, vy), the
#: texel start and width, and s_num.
SLOT_BYTES = 16 + 8 + 4
#: Dynamic shared memory a launch gets without opting in to more: the most
#: either kernel takes.
SMEM_BYTES = 48 * 1024


def _lib():
    lib = kernels.load('observe')
    fn = lib.observe
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 8 + [i] * 9 + [f, f] + [p] * 5
        fn.restype = ctypes.c_int
    return fn


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f'{name} is on {x.device}, expected {device}')
    if x.dtype != dtype:
        raise TypeError(f'{name} is {x.dtype}, expected {dtype}')
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(x.shape)}, expected {tuple(shape)}')
    if not x.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def observe(lines, lines_width, tex_starts, tex_widths, table, angles, positions,
            res, half_screen_width, agent_radius, want_seen=True, skip_dyn=0,
            baked_dyn=None, draw_model=0, fast_div=False):
    """Fused raycast + shade (+ seen mask) over the whole env batch.

    On CUDA tensors this launches ``csrc/observe.cu`` on the current stream,
    without synchronising, and adds one to ``observe.launches``. On CPU tensors
    it runs :func:`observe_plain`. There is no fallback from one to the other.

    :param lines: (N, L, 2, 2) f32, this frame's lines; with ``draw_model``, the
        static scenery lines, whose head slots hold the unrotated model. Padded
        slots are zero; the kernel also stops at ``lines_width``.
    :param lines_width: (N,) i32 true line counts.
    :param tex_starts, tex_widths: (N, L) i32 texel range of each line.
    :param table: (N, T, 4) f32 ``[r, g, b, baked]`` per texel
        (:func:`render.pack_table`), packed once at env build.
    :param angles: (N, A) f32 degrees. :param positions: (N, A, 2) f32 meters.
    :param want_seen: whether to return the seen mask; without it nothing is
        allocated for it.
    :param skip_dyn: leading line slots left out of the raycast (the agent models
        of a single-agent env, which the camera's near plane hides). Reported
        indices stay in the full line array's id space.
    :param baked_dyn: (N, T_dyn) f32, this frame's intensity of the first
        ``T_dyn`` texels (the agent models' re-bake, Deathmatch): it replaces the
        table's baked channel there, while the colours stay the table's.
    :param draw_model: lines per agent model. If set, the kernel rotates and
        moves the ``A * draw_model`` head slots of ``lines`` by their owning
        agent's pose itself, with :func:`render.place`'s arithmetic. Excludes
        ``skip_dyn``.
    :param fast_div: one shared reciprocal in place of the raycast's two
        divisions (see :func:`render.intersections`).
    :return: arrdict with ``indices`` (N, A, R) i32 (-1 on a miss), ``distances``
        (N, A, R) f32 (inf on a miss), ``screen`` (N, A, 3, R) f32 and, if
        ``want_seen``, ``seen`` (N, T) bool.
    """
    _check_modes(skip_dyn, draw_model)
    if lines.device.type == 'cpu':
        return observe_plain(lines, lines_width, tex_starts, tex_widths, table,
                             angles, positions, res, half_screen_width,
                             agent_radius, want_seen, skip_dyn, baked_dyn,
                             draw_model, fast_div)
    if lines.device.type != 'cuda':
        raise ValueError(f'observe runs on cuda or cpu, not {lines.device}')

    dev = lines.device
    N, L = lines.shape[:2]
    A = angles.shape[1]
    T = table.shape[1]
    f32, i32 = torch.float32, torch.int32
    _check('lines', lines, f32, (N, L, 2, 2), dev)
    _check('lines_width', lines_width, i32, (N,), dev)
    _check('tex_starts', tex_starts, i32, (N, L), dev)
    _check('tex_widths', tex_widths, i32, (N, L), dev)
    _check('table', table, f32, (N, T, 4), dev)
    _check('angles', angles, f32, (N, A), dev)
    _check('positions', positions, f32, (N, A, 2), dev)
    T_dyn = 0
    if baked_dyn is not None:
        T_dyn = baked_dyn.shape[-1]
        _check('baked_dyn', baked_dyn, f32, (N, T_dyn), dev)
        if T_dyn > T:
            raise ValueError(f'baked_dyn has {T_dyn} texels, the table {T}')
    if not 0 <= skip_dyn <= L:
        raise ValueError(f'skip_dyn={skip_dyn} outside [0, {L}]')
    if not 0 <= A * draw_model <= L:
        raise ValueError(f'draw_model={draw_model} lines for {A} agents '
                         f'exceed {L} line slots')
    if (L - skip_dyn) * SLOT_BYTES > SMEM_BYTES:
        raise ValueError(f'{L - skip_dyn} line slots exceed the kernel\'s '
                         f'{SMEM_BYTES} bytes of shared memory')
    if not agent_radius >= 0:
        raise ValueError(f'agent_radius={agent_radius}: the kernel\'s divide-free '
                         'rejections need a radius >= 0')

    with torch.cuda.device(dev):
        indices = torch.empty((N, A, res), dtype=i32, device=dev)
        distances = torch.empty((N, A, res), dtype=f32, device=dev)
        screen = torch.empty((N, A, 3, res), dtype=f32, device=dev)
        seen = torch.zeros((N, T), dtype=torch.bool, device=dev) if want_seen else None
        err = _lib()(
            lines.data_ptr(), lines_width.data_ptr(), tex_starts.data_ptr(),
            tex_widths.data_ptr(), table.data_ptr(),
            None if baked_dyn is None else baked_dyn.data_ptr(),
            angles.data_ptr(), positions.data_ptr(), N, A, L, T, T_dyn, res,
            skip_dyn, draw_model, int(fast_div), float(half_screen_width),
            float(agent_radius), indices.data_ptr(), distances.data_ptr(),
            screen.data_ptr(), None if seen is None else seen.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f'observe kernel launch failed: CUDA error {err}')
    observe.launches += 1
    out = arrdict(indices=indices, distances=distances, screen=screen)
    if want_seen:
        out['seen'] = seen
    return out


#: Kernel launches so far; a caller resets it to 0 before a run it counts.
observe.launches = 0


def rebake_smem_bytes(walls, lights, texels):
    """Shared memory of one re-bake block: a float4 per wall slot and per
    light, a float2 per texel center, and an f32 per (light, wall) and per
    (light, texel)."""
    return 16 * walls + 16 * lights + 8 * texels + 4 * lights * (walls + texels)


def _rebake_lib():
    fn = kernels.load('observe').rebake
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 8 + [i, i, i, ctypes.c_longlong, i, i, i, i, i, i]
                       + [p, p])
        fn.restype = ctypes.c_int
    return fn


def rebake(scenery, dyn_lines, walls, k_max=None):
    """This frame's light of the agent-model texels: one CUDA kernel
    (``csrc/observe.cu``, ``rebake_kernel``) in place of
    :func:`bake.dynamic_texel_intensity_parts`, whose arguments it takes.

    On CUDA tensors this launches the kernel on the current stream, without
    synchronising, adds one to ``rebake.launches`` and counts
    ``rebake_launches`` in :mod:`~megastep_tpu_torch.tracing`. On CPU tensors
    it runs :func:`bake.dynamic_texel_intensity_parts` and launches nothing.
    There is no fallback from one to the other. Every occlusion decision is
    the plain version's; the sum over the lights may round differently in its
    last bits.

    :param scenery: the :class:`~megastep_tpu_torch.scene.Scenery`: its lights,
        line and light counts, and texel tables.
    :param dyn_lines: (N, n_dynamic, 2, 2) f32, this frame's drawn agent models
        (:func:`render.draw_dynamic`).
    :param walls: (N, W, 2, 2) f32, the static walls
        (``scenery.lines[:, n_dynamic:]``); each env's slots must be contiguous,
        its rows may lie any stride apart. Slots from
        ``lines_width - n_dynamic`` on are left out.
    :param k_max: a bound on the per-env light count; the light slots past it
        are left out.
    :return: (N, n_dynamic_texels) f32.
    """
    if dyn_lines.device.type == 'cpu':
        return bake.dynamic_texel_intensity_parts(scenery, dyn_lines, walls,
                                                  k_max=k_max)
    if dyn_lines.device.type != 'cuda':
        raise ValueError(f'rebake runs on cuda or cpu, not {dyn_lines.device}')

    dev = dyn_lines.device
    N, L = scenery.lines.shape[:2]
    nd, P = scenery.n_dynamic, scenery.n_dynamic_texels
    K_full = scenery.lights.shape[1]
    T = scenery.tex_line.shape[1]
    f32, i32 = torch.float32, torch.int32
    _check('dyn_lines', dyn_lines, f32, (N, nd, 2, 2), dev)
    _check('lines_width', scenery.lines_width, i32, (N,), dev)
    _check('lights', scenery.lights, f32, (N, K_full, 3), dev)
    _check('lights_width', scenery.lights_width, i32, (N,), dev)
    _check('tex_line', scenery.tex_line, i32, (N, T), dev)
    _check('line_tex_starts', scenery.line_tex_starts, i32, (N, L), dev)
    _check('line_tex_widths', scenery.line_tex_widths, i32, (N, L), dev)
    if walls.device != dev:
        raise ValueError(f'walls is on {walls.device}, expected {dev}')
    if walls.dtype != f32:
        raise TypeError(f'walls is {walls.dtype}, expected {f32}')
    if walls.dim() != 4 or walls.shape[0] != N or tuple(walls.shape[2:]) != (2, 2):
        raise ValueError(f'walls has shape {tuple(walls.shape)}, expected ({N}, W, 2, 2)')
    W = walls.shape[1]
    if N and not walls[0].is_contiguous():
        raise ValueError('each env\'s wall slots must be contiguous')
    if P > T or nd > L:
        raise ValueError(f'{P} dynamic texels or {nd} dynamic lines exceed the '
                         f'scenery\'s {T} texels or {L} lines')
    if k_max is not None and k_max < 0:
        raise ValueError(f'k_max={k_max} is negative')
    K = K_full if k_max is None else min(k_max, K_full)
    smem = rebake_smem_bytes(W, K, P)
    if smem > SMEM_BYTES:
        raise ValueError(f'{W} wall slots, {K} lights and {P} texels need {smem} '
                         f'bytes of shared memory, over the kernel\'s {SMEM_BYTES}')

    with torch.cuda.device(dev):
        out = torch.empty((N, P), dtype=f32, device=dev)
        err = _rebake_lib()(
            dyn_lines.data_ptr(), walls.data_ptr(), scenery.lines_width.data_ptr(),
            scenery.lights.data_ptr(), scenery.lights_width.data_ptr(),
            scenery.tex_line.data_ptr(), scenery.line_tex_starts.data_ptr(),
            scenery.line_tex_widths.data_ptr(), N, nd, W,
            walls.stride(0) if N else 0, K, K_full, P, T, L, smem, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f'rebake kernel launch failed: CUDA error {err}')
    rebake.launches += 1
    tracing.count('rebake_launches')
    return out


#: Kernel launches so far; a caller resets it to 0 before a run it counts.
rebake.launches = 0
