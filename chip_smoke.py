"""Smoke run of the PyTorch/CUDA port (``megastep_tpu_torch``) on one NVIDIA GPU.

Builds the port's CUDA kernels from ``megastep_tpu_torch/csrc``, prints what
their SASS shows (for each instantiation of the observe kernel, its divides and
the straight path of its loop over the line slots), holds each of them (each
mode of the observe kernel, also on crafted edge cases and on scenes of more
than 64 live line slots) against its plain torch version on the card, and
drives the port's three paths at full size:

- the roofline (``megastep_tpu_torch.perf.roofline``): the f32 multiply probe
  (K2) on the JAX probe's (64, 8, 256, 512) input, the device-memory and bf16
  matmul probes, and, in each env's phase below, the analytic table of its
  observe kernel;
- Explorer: 16,384 envs on procedural floorplans, res 256 pooled by 4 into RGB +
  depth + IMU, momentum movement and the seen-texel reward;
- Deathmatch: 16,384 agent-envs (4,096 scenes of 4 agents), res 512 pooled by 4
  into RGB + depth + IMU + health, momentum movement, the per-frame re-bake of
  the agent models, the shoot test and respawn at death; then shorter runs of
  the same env with the in-kernel draw (``draw_fused``) and with ``fast_div``.

Any failed phase raises, and the script then exits non-zero without its last
line. Run it from the repository root:

    python3 chip_smoke.py            # add --profile for a per-kernel breakdown

It prints progress lines, one ``{"main_path": {...}}`` JSON line per env, a
``{"roofline": {...}}`` line, a ``{"kernels": [...]}`` JSON line, the card's
name and power limit as ``nvidia-smi`` gives them, and last ``{"ok": true,
"device": {...}}``. Without a CUDA device it exits with code 2 and prints no
result.
"""
import argparse
import functools
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

N_ENVS, RES, SUBSAMPLE, STEPS = 16384, 256, 4, 32
DM_ENVS, DM_AGENTS, DM_RES = 16384, 4, 512  # agent-envs; scenes = envs / agents
DM_MODE_STEPS = 8          # steps of the draw_fused and fast_div runs
DEVICE = 'cuda'
N_CHECK = 2048             # Explorer envs of the kernel-vs-plain check
DM_CHECK = 2048            # Deathmatch agent-envs (512 scenes) of the same check
N_GEOMETRIES = 512         # floorplans, tiled over the scenes as bench.py does
N_WIDE = 64                # scenes of more than 64 live line slots
BOUNDARY = 1e-6            # a second candidate this close to the tolerance edge
MAX_BOUNDARY_SHARE = 1e-4  # rays allowed to differ, all of them on that edge
TOL = dict(rtol=1e-5, atol=1e-6)
VPU_SHAPE, VPU_CHAIN = (64, 8, 256, 512), 256  # the JAX probe's defaults
VPU_RAGGED = 4 * 100_003 + 1  # elements: not whole float4s
KERNELS = ('observe', 'vpu_probe')

#: The Deathmatch modes of the kernel, as observe() arguments past the inputs.
#: 'patch' and 'fast_div' read this frame's drawn lines, 'draw_model' the static
#: ones; all three take the re-baked model texels as baked_dyn.
DM_MODES = ('patch', 'draw_model', 'fast_div')
#: Where each mode sits in the JAX package's Pallas kernel.
REPLACES = {'explorer': 'megastep_tpu/ops/fused.py:166',
            'patch': 'megastep_tpu/ops/fused.py:202',
            'draw_model': 'megastep_tpu/ops/fused.py:240',
            'fast_div': 'megastep_tpu/ops/fused.py:307'}


def log(*args):
    print(*args, flush=True)


def sass_text(kernels, name):
    """``cuobjdump -sass`` of kernel ``name``'s built library."""
    tool = Path(kernels.nvcc()).resolve().with_name('cuobjdump')
    return subprocess.run([str(tool), '-sass', str(kernels.library_path(name))],
                          capture_output=True, text=True, timeout=120, check=True).stdout


SASS_LINE = re.compile(r'/\*([0-9a-f]+)\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9.]*)([^;]*);')


def sass_functions(text):
    """Each function's instructions, ``[(address, predicated, opcode,
    operands)]`` in address order, by mangled name."""
    out = {}
    for part in text.split('Function : ')[1:]:
        name = part.split(None, 1)[0]
        out[name] = [(int(a, 16), bool(p), op, rest)
                     for a, p, op, rest in SASS_LINE.findall(part)]
    return out


def sass_opcodes(text):
    """The opcodes, with their modifiers, of every function in ``text``."""
    return [op for _, _, op, _ in SASS_LINE.findall(text)]


def slot_loop(code):
    """The observe kernel's loop over the line slots: the innermost loop (a
    backward BRA) around the function's first ``LDS.128``. Returns its first
    and last address, its instructions, and the opcodes of the shortest path
    from its head to its backward branch: the path of a slot whose tests are
    all rejected without a divide."""
    first = next(a for a, _, op, _ in code if op == 'LDS.128')
    loops = [(int(re.search(r'0x([0-9a-f]+)', rest).group(1), 16), a)
             for a, _, op, rest in code if op == 'BRA' and '0x' in rest]
    head, tail = min(((t, a) for t, a in loops if t <= first < a),
                     key=lambda ta: ta[1] - ta[0])
    body = [c for c in code if head <= c[0] <= tail]
    at = {c[0]: i for i, c in enumerate(body)}
    # Breadth-first over the body's control flow, one step per instruction.
    prev, frontier = {0: None}, [0]
    while frontier and len(body) - 1 not in prev:
        nxt = []
        for i in frontier:
            _, pred, op, rest = body[i]
            succ = []
            if op == 'BRA':
                target = int(re.search(r'0x([0-9a-f]+)', rest).group(1), 16)
                succ += [at[target]] if target in at and i != len(body) - 1 else []
                succ += [i + 1] if pred else []
            elif op != 'EXIT':
                succ.append(i + 1)
            for j in succ:
                if j < len(body) and j not in prev:
                    prev[j] = i
                    nxt.append(j)
        frontier = nxt
    path, i = [], len(body) - 1
    while i is not None:
        path.append(body[i][2])
        i = prev[i]
    return head, tail, [c[2] for c in body], path[::-1]


def observe_sass(text):
    """For each instantiation of the observe kernel (``fast_div`` off and
    on): its ``MUFU.RCP`` count and its slot loop's. Raises if the loop's shortest path, the one every
    test rejected without a divide takes, holds a ``MUFU.RCP``."""
    rows = []
    for name, code in sass_functions(text).items():
        m = re.search(r'observe_kernelILb([01])E', name)
        if not m:
            continue
        ops = [c[2] for c in code]
        head, tail, body, path = slot_loop(code)
        row = dict(fast_div=bool(int(m.group(1))), instructions=len(ops), mufu_rcp=ops.count('MUFU.RCP'),
                   loop=f'{head:#x}-{tail:#x}', loop_instructions=len(body),
                   loop_mufu_rcp=body.count('MUFU.RCP'), straight=len(path),
                   straight_mufu_rcp=path.count('MUFU.RCP'))
        log(f'observe<fast_div={row["fast_div"]}> SASS: '
            f'{row["mufu_rcp"]} MUFU.RCP in {row["instructions"]} instructions; '
            f'slot loop {row["loop"]}: {row["loop_instructions"]} instructions, '
            f'{row["loop_mufu_rcp"]} MUFU.RCP; its straight path (every test '
            f'rejected without a divide): {row["straight"]} instructions, '
            f'{row["straight_mufu_rcp"]} MUFU.RCP: {" ".join(path)}')
        if row['straight_mufu_rcp']:
            raise AssertionError('a divide sits on the slot loop\'s straight path')
        rows.append(row)
    if len(rows) != 2:
        raise AssertionError(f'{len(rows)} observe kernel instantiations, not 2')
    return rows


def count(ops, names):
    return {n: sum(op == n or op.startswith(n + '.') for op in ops) for n in names}


def divide_fast_path(ops):
    """The shortest run of opcodes of an IEEE divide that takes its fast path:
    from the MUFU.RCP and the BSSY before an FCHK to the branch past the slow
    path after it, and the BSYNC that branch lands on."""
    best = []
    for i, op in enumerate(ops):
        rcp = [j for j in range(i) if ops[j] == 'MUFU.RCP']
        bssy = [j for j in range(i) if ops[j] == 'BSSY']
        bra = [j for j in range(i, len(ops)) if ops[j] == 'BRA']
        if op != 'FCHK' or not (rcp and bssy and bra) or 'BSYNC' not in ops[bra[0]:]:
            continue
        run = ops[min(rcp[-1], bssy[-1]):bra[0] + 1] + ['BSYNC']
        if not best or len(run) < len(best):
            best = run
    return best


def time_ms(torch, fn, reps):
    """Device time of one call of ``fn``, by CUDA events over ``reps`` calls after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tiled(geoms, n):
    return [geoms[i % len(geoms)] for i in range(n)]


def deathmatch_modes(env, agents):
    """Each Deathmatch mode's observe() arguments at ``agents``' poses, as
    ``(args, kwargs)``, and the drawn lines that every mode raycasts. ``env``
    runs the default mode, the patch launch on drawn lines."""
    scn = env.core.scenery
    args, kw = env.observe_args(agents)
    drawn = args[0]
    modes = {'patch': (args, kw),
             'draw_model': ((scn.lines, *args[1:]),
                            dict(kw, draw_model=scn.n_model_lines)),
             'fast_div': (args, dict(kw, fast_div=True))}
    return modes, drawn


def check_observe(torch, fused, render, args, kwargs, drawn=None):
    """The observe kernel against its plain version on the same inputs.

    Indices must be equal, except on rays where a second candidate line lies
    within ``BOUNDARY`` of the plain version's tolerance edge ``s_min +
    render.Z_TOLERANCE`` (one ulp can flip those), and those may be at most
    ``MAX_BOUNDARY_SHARE`` of the rays. On the other rays, distances and the
    screen must be allclose, and the seen mask (if asked for) must be equal on
    every env with no such ray. ``drawn`` is the line array the raycast sees,
    if not ``args[0]`` (the in-kernel draw). Returns the kernel's output and
    the comparison's numbers.
    """
    got = fused.observe(*args, **kwargs)
    want = fused.observe_plain(*args, **kwargs)
    torch.cuda.synchronize()
    skip = kwargs.get('skip_dyn', 0)
    lines = args[0] if drawn is None else drawn
    x = render.intersections(lines[:, skip:], args[1] - skip, *args[5:],
                             fast_div=kwargs.get('fast_div', False))
    s = torch.where(x.valid, x.s, math.inf)
    edge = s.amin(-1, keepdim=True) + render.Z_TOLERANCE
    boundary = (x.valid & ((s - edge).abs() < BOUNDARY)).any(-1)
    del x, s, edge

    differ = got.indices != want.indices
    if (differ & ~boundary).any():
        raise AssertionError(f'{int((differ & ~boundary).sum())} rays pick another '
                             'line than the plain version, off the tolerance edge')
    n_rays, n_differ = differ.numel(), int(differ.sum())
    if n_differ > MAX_BOUNDARY_SHARE * n_rays:
        raise AssertionError(f'{n_differ} of {n_rays} rays differ on the edge')
    agree = ~differ
    if ('seen' in got) != ('seen' in want) or ('seen' in got) != kwargs.get('want_seen', True):
        raise AssertionError('seen mask returned against want_seen')
    if 'seen' in got:
        env_ok = ~differ.flatten(1).any(1)
        if (got.seen != want.seen)[env_ok].any():
            raise AssertionError('seen masks differ')
    d_got, d_want = got.distances[agree], want.distances[agree]
    s_got = got.screen.transpose(2, 3)[agree]
    s_want = want.screen.transpose(2, 3)[agree]
    if not (torch.allclose(d_got, d_want, **TOL)
            and torch.allclose(s_got, s_want, **TOL)):
        raise AssertionError('distances or screen differ beyond rtol=1e-5, atol=1e-6')
    finite = torch.isfinite(d_want)
    err = max(float((d_got - d_want)[finite].abs().max()),
              float((s_got - s_want).abs().max()))
    return got, dict(rays=n_rays, edge_rays=int(boundary.sum()),
                     differing=n_differ, max_abs_err=err,
                     hits=int((want.indices >= 0).sum()))


def check_modes(torch, fused, render, modes, drawn, where):
    """Every Deathmatch mode against its plain version; the in-kernel draw must
    also equal the patch launch on drawn lines, bit for bit."""
    outs, nums = {}, {}
    for mode in DM_MODES:
        args, kw = modes[mode]
        outs[mode], nums[mode] = check_observe(torch, fused, render, args, kw, drawn)
        log(f'check {mode} at {where}: {nums[mode]}')
    for k in ('indices', 'distances', 'screen'):
        if not torch.equal(outs['draw_model'][k], outs['patch'][k]):
            raise AssertionError(f'draw_model {k} differ from the drawn-lines launch')
    return outs, nums


def stepper(torch, env, state, g):
    """A step of ``env`` from ``state`` with random actions from generator
    ``g``; each call returns the new state and keeps it for the next."""
    from megastep_tpu_torch.arrdict import arrdict

    def step():
        nonlocal state
        actions = torch.randint(0, 7, (env.n_envs, 1), generator=g, device=DEVICE)
        state, _ = env.step(state, arrdict(actions=actions), g)
        return state
    return step


def profile_steps(torch, name, step, step_ms, n=4):
    """Device time by kernel over ``n`` calls of ``step``, from torch.profiler,
    and the share of an unprofiled step's wall time ``step_ms`` that the device
    is idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    # Device-side events only: the CPU ops that launch kernels also report
    # their kernels' time, which would count it twice.
    rows = [(e.key, e.self_device_time_total / 1e3 / n, e.count // n)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    log(f'profile {name}: {total:.3f} ms of device time per step in {len(rows)} '
        f'kernels, {sum(r[2] for r in rows)} launches per step; idle share of a '
        f'{step_ms:.3f} ms step {1 - total / step_ms:.3f}')
    for key, ms, count in rows[:15]:
        log(f'  {ms:9.4f} ms/step  {count:4d}x  {key[:90]}')


def time_observe(torch, fused, args, kwargs):
    """CUDA-event times of the kernel (20 launches) and its plain version (3)."""
    ms = time_ms(torch, lambda: fused.observe(*args, **kwargs), 20)
    plain_ms = time_ms(torch, lambda: fused.observe_plain(*args, **kwargs), 3)
    return ms, plain_ms


def kernel_entry(mode, launches, err, ms, plain_ms, bound_ms, bound_by):
    # No single PyTorch call computes this function, so library_ms is null.
    return {'name': f'observe ({mode})', 'route': 'cuda',
            'source': 'megastep_tpu_torch/csrc/observe.cu',
            'replaces': REPLACES[mode], 'launches': launches, 'max_abs_err': err,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
            'bound_by': bound_by, 'library_ms': None}


def explorer_phase(torch, opts, geoms, peaks):
    """Explorer: kernel against plain at N_CHECK and N_ENVS envs, the main path
    at N_ENVS envs, then its roofline table at ``peaks``. Returns its main_path
    line, its kernel entry, its table, and with ``--profile`` a callable that
    profiles its step."""
    from megastep_tpu_torch import envs
    from megastep_tpu_torch.arrdict import arrdict
    from megastep_tpu_torch.ops import bake, fused, render
    from megastep_tpu_torch.perf import roofline
    from megastep_tpu_torch.perf.step_rate import timed_windows

    env = envs.Explorer(N_CHECK, geometries=tiled(geoms, N_CHECK), res=RES,
                        subsample=SUBSAMPLE, random=np.random.RandomState(1),
                        device=DEVICE)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(1)
    state, _ = env.reset(g)
    angles = torch.rand(state.agents.angles.shape, generator=g, device=DEVICE) * 360 - 180
    agents = arrdict(angles=angles, positions=state.agents.positions)
    skip = env.core.scenery.n_dynamic
    _, small = check_observe(torch, fused, render, *env.observe_args(agents))
    log(f'check explorer at {N_CHECK} envs: {small}')
    del env, state, agents

    t0 = time.perf_counter()
    env = envs.Explorer(N_ENVS, geometries=tiled(geoms, N_ENVS), res=RES,
                        subsample=SUBSAMPLE, random=np.random.RandomState(0),
                        device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    scn = env.core.scenery
    t0 = time.perf_counter()
    bake.bake(scn)
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    log(f'explorer: {N_ENVS} envs built in {build_s:.2f} s (bake alone {bake_s:.2f} s); '
        f'lines {tuple(scn.lines.shape)} texels {tuple(scn.baked.shape)} '
        f'lights {tuple(scn.lights.shape)}')

    g = torch.Generator(device=DEVICE)
    g.manual_seed(0)
    fused.observe.launches = 0
    state, world = env.reset(g)
    ok = torch.ones((), dtype=torch.bool, device=DEVICE)
    shapes = dict(rgb=(N_ENVS, 1, 3, 1, RES // SUBSAMPLE),
                  d=(N_ENVS, 1, 1, 1, RES // SUBSAMPLE), imu=(N_ENVS, 1, 3))
    for _ in range(STEPS):
        actions = torch.randint(0, 7, (N_ENVS, 1), generator=g, device=DEVICE)
        prev = state.potential
        state, world = env.step(state, arrdict(actions=actions), g)
        for k, shape in shapes.items():
            if tuple(world.obs[k].shape) != shape:
                raise AssertionError(f'obs.{k} has shape {tuple(world.obs[k].shape)}')
            ok &= torch.isfinite(world.obs[k]).all()
        for k in ('rgb', 'd'):
            ok &= ((world.obs[k] >= 0) & (world.obs[k] <= 1)).all()
        ok &= torch.isfinite(world.reward).all() & (world.reward >= 0).all()
        ok &= ((state.potential >= prev) | world.reset).all()
    torch.cuda.synchronize()
    launches = fused.observe.launches
    if launches != 1 + STEPS:
        raise AssertionError(f'observe kernel launched {launches} times in '
                             f'reset + {STEPS} steps')
    if not bool(ok):
        raise AssertionError('observations, rewards or potentials out of range')
    log(f'explorer main path: reset + {STEPS} steps, observe kernel launches '
        f'{launches}, mean reward {float(world.reward.mean()):.4f}, '
        f'mean potential {float(state.potential.mean()):.1f}')

    step = stepper(torch, env, state, g)
    windows, step_s, state = timed_windows(torch, step)
    log(f'explorer throughput: {N_ENVS / step_s:.0f} env-steps/s '
        f'({1e3 * step_s:.3f} ms/step over {len(windows)} windows of {STEPS} '
        f'steps: {", ".join(f"{1e3 * w:.3f}" for w in windows)})')

    # The kernel and its plain version at the main path's shapes.
    args, kw = env.observe_args(state.agents)
    out, full = check_observe(torch, fused, render, args, kw)
    log(f'check explorer at {N_ENVS} envs: {full}')
    ms, plain_ms = time_observe(torch, fused, args, kw)
    bound_ms, bound_by, work = roofline.bound(scn, out, skip)
    log(f'observe (explorer): {ms:.4f} ms/launch, plain {plain_ms:.3f} ms, '
        f'bound {bound_ms:.4f} ms ({bound_by}; {work})')
    profile = (functools.partial(profile_steps, torch, 'explorer', step, 1e3 * step_s)
               if opts.profile else None)
    table = roofline.analytic('explorer', env, 1e3 * step_s, peaks)
    main = {'env': 'Explorer', 'n_envs': N_ENVS, 'res': RES, 'subsample': SUBSAMPLE,
            'steps': STEPS, 'env_steps_per_s': N_ENVS / step_s,
            'ms_per_step': 1e3 * step_s, 'ms_per_step_windows': [1e3 * w for w in windows],
            'build_s': build_s, 'bake_s': bake_s}
    return main, kernel_entry('explorer', launches, full['max_abs_err'], ms,
                              plain_ms, bound_ms, bound_by), table, profile


def deathmatch_phase(torch, opts, geoms, peaks):
    """Deathmatch: every mode against plain at DM_CHECK and DM_ENVS agent-envs,
    the main path at DM_ENVS, its roofline table at ``peaks``, and short runs
    with draw_fused and fast_div. Returns its main_path line, its three kernel
    entries, its table, and with ``--profile`` a callable that profiles its
    step."""
    from megastep_tpu_torch import envs
    from megastep_tpu_torch.arrdict import arrdict
    from megastep_tpu_torch.ops import bake, fused, render
    from megastep_tpu_torch.perf import roofline
    from megastep_tpu_torch.perf.step_rate import timed_windows

    def build(n, seed, **kwargs):
        return envs.Deathmatch(n, n_agents=DM_AGENTS,
                               geometries=tiled(geoms, n // DM_AGENTS), res=DM_RES,
                               subsample=SUBSAMPLE, random=np.random.RandomState(seed),
                               device=DEVICE, **kwargs)

    env = build(DM_CHECK, 1)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(1)
    state, _ = env.reset(g)
    angles = torch.rand(state.agents.angles.shape, generator=g, device=DEVICE) * 360 - 180
    agents = arrdict(angles=angles, positions=state.agents.positions)
    modes, drawn = deathmatch_modes(env, agents)
    check_modes(torch, fused, render, modes, drawn, f'{DM_CHECK} agent-envs')
    del env, state, agents, modes, drawn

    t0 = time.perf_counter()
    env = build(DM_ENVS, 0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    scn = env.core.scenery
    t0 = time.perf_counter()
    bake.bake(scn)
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    n_scenes = scn.n_envs
    log(f'deathmatch: {DM_ENVS} agent-envs ({n_scenes} scenes x {DM_AGENTS}) built '
        f'in {build_s:.2f} s (bake alone {bake_s:.2f} s); lines '
        f'{tuple(scn.lines.shape)} ({scn.n_dynamic} dynamic) texels '
        f'{tuple(scn.baked.shape)} ({scn.n_dynamic_texels} dynamic) lights '
        f'{tuple(scn.lights.shape)}')

    ds = DM_RES // SUBSAMPLE
    shapes = dict(rgb=(DM_ENVS, 1, 3, 1, ds), d=(DM_ENVS, 1, 1, 1, ds),
                  imu=(DM_ENVS, 1, 3), health=(DM_ENVS, 1, 1))

    def run(env, steps, seed, keep=0):
        """Reset + ``steps`` steps from generator seed ``seed``; checks each
        world and returns the run's numbers and the first ``keep`` worlds."""
        g = torch.Generator(device=DEVICE)
        g.manual_seed(seed)
        fused.observe.launches = 0
        state, world = env.reset(g)
        kept = [world][:keep]
        ok = torch.ones((), dtype=torch.bool, device=DEVICE)
        shots = respawns = 0
        for _ in range(steps):
            actions = torch.randint(0, 7, (DM_ENVS, 1), generator=g, device=DEVICE)
            prev = state.health
            state, world = env.step(state, arrdict(actions=actions), g)
            for k, shape in shapes.items():
                if tuple(world.obs[k].shape) != shape:
                    raise AssertionError(f'obs.{k} has shape {tuple(world.obs[k].shape)}')
                ok &= torch.isfinite(world.obs[k]).all()
            for k in ('rgb', 'd'):
                ok &= ((world.obs[k] >= 0) & (world.obs[k] <= 1)).all()
            # Respawn only where health was <= 0; there health restarts at 1
            # less at most this step's wounds and penalty, elsewhere it falls.
            dead = prev <= 0
            ok &= (world.reset == dead.reshape(-1)).all()
            ok &= torch.where(dead, state.health > .75, state.health < prev).all()
            ok &= torch.isfinite(world.reward).all() & (world.reward >= 0).all()
            shots += state.matchings.sum()
            respawns += dead.sum()
            if len(kept) < keep:
                kept.append(world)
        torch.cuda.synchronize()
        if not bool(ok):
            raise AssertionError('observations, health, rewards or respawns out of range')
        nums = dict(launches=fused.observe.launches, shots=int(shots),
                    respawns=int(respawns))
        return state, nums, kept

    state, main_nums, ref = run(env, STEPS, 0, keep=1 + DM_MODE_STEPS)
    if main_nums['launches'] != 1 + STEPS:
        raise AssertionError(f'observe kernel launched {main_nums["launches"]} times '
                             f'in reset + {STEPS} steps')
    if main_nums['shots'] == 0:
        raise AssertionError(f'no shot landed in {STEPS} steps')
    log(f'deathmatch main path: reset + {STEPS} steps, {main_nums}')

    g = torch.Generator(device=DEVICE)
    g.manual_seed(2)

    step = stepper(torch, env, state, g)
    windows, step_s, state = timed_windows(torch, step)
    log(f'deathmatch throughput: {DM_ENVS / step_s:.0f} agent-steps/s '
        f'({1e3 * step_s:.3f} ms/step over {len(windows)} windows of {STEPS} '
        f'steps: {", ".join(f"{1e3 * w:.3f}" for w in windows)})')

    # Every mode and its plain version at the main path's shapes.
    modes, drawn = deathmatch_modes(env, state.agents)
    outs, checks = check_modes(torch, fused, render, modes, drawn,
                               f'{DM_ENVS} agent-envs')
    # The step's other large stage: the per-frame re-bake of the model texels.
    rebake_ms = time_ms(torch, lambda: bake.dynamic_texel_intensity_parts(
        scn, render.draw_dynamic(scn, state.agents), scn.lines[:, scn.n_dynamic:],
        k_max=env._k_lights), 5)
    log(f'draw + re-bake: {rebake_ms:.4f} ms')
    timed = {}
    for mode in DM_MODES:
        args, kw = modes[mode]
        ms, plain_ms = time_observe(torch, fused, args, kw)
        bound_ms, bound_by, work = roofline.bound(scn, outs[mode], 0,
                                                  scn.n_dynamic_texels,
                                                  fast_div=mode == 'fast_div')
        timed[mode] = (ms, plain_ms, bound_ms, bound_by)
        log(f'observe ({mode}): {ms:.4f} ms/launch, plain {plain_ms:.3f} ms, '
            f'bound {bound_ms:.4f} ms ({bound_by}; {work})')
    del modes, drawn, outs
    log(f'peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    profile = (functools.partial(profile_steps, torch, 'deathmatch', step,
                                 1e3 * step_s) if opts.profile else None)
    table = roofline.analytic('deathmatch', env, 1e3 * step_s, peaks)
    del env, state, step

    # The same env with the in-kernel draw, then with fast_div, from the main
    # path's seed: the in-kernel draw must repeat its worlds bit for bit.
    launches = {'patch': main_nums['launches']}
    for mode, kwargs in (('draw_model', dict(draw_fused=True)),
                         ('fast_div', dict(fast_div=True))):
        env = build(DM_ENVS, 0, **kwargs)
        _, nums, kept = run(env, DM_MODE_STEPS, 0, keep=1 + DM_MODE_STEPS)
        launches[mode] = nums['launches']
        if nums['launches'] != 1 + DM_MODE_STEPS:
            raise AssertionError(f'{mode}: observe kernel launched '
                                 f'{nums["launches"]} times')
        diff = max(float((a.obs[k] - b.obs[k]).abs().max())
                   for a, b in zip(kept, ref) for k in ('rgb', 'd'))
        if mode == 'draw_model' and diff:
            raise AssertionError(f'draw_fused observations differ from the main '
                                 f'path by up to {diff}')
        log(f'deathmatch {mode} run: reset + {DM_MODE_STEPS} steps, {nums}, '
            f'observations within {diff} of the main path\'s')
        del env, kept

    main = {'env': 'Deathmatch', 'agent_envs': DM_ENVS, 'scenes': n_scenes,
            'agents': DM_AGENTS, 'res': DM_RES, 'subsample': SUBSAMPLE,
            'steps': STEPS, 'agent_steps_per_s': DM_ENVS / step_s,
            'ms_per_step': 1e3 * step_s, 'ms_per_step_windows': [1e3 * w for w in windows],
            'build_s': build_s, 'bake_s': bake_s,
            'rebake_ms': rebake_ms, 'shots': main_nums['shots'],
            'respawns': main_nums['respawns']}
    return main, [kernel_entry(m, launches[m], checks[m]['max_abs_err'], *timed[m])
                  for m in DM_MODES], table, profile


def edges_phase(torch):
    """The crafted edge cases and the wide scenes (more than 64 live line
    slots, past the kernel's candidate mask), every mode against the plain
    version: no ray may differ, and each crafted case's middle ray must pick
    its named slot."""
    from megastep_tpu_torch import constants, scene
    from megastep_tpu_torch.ops import fused, render
    from megastep_tpu_torch.perf import observe_edges as edges

    hsw = math.tan(math.pi / 180 * 130 / 2)
    radius = constants.AGENT_RADIUS
    for mode in edges.MODES:
        A = 1 if mode == 'explorer' else DM_AGENTS
        res = RES if mode == 'explorer' else DM_RES
        crafted = edges.crafted_scenery(A, DEVICE)
        lines, angles, positions, winners = edges.crafted(crafted, radius)
        wide = scene.scenery(edges.wide_geometries(N_WIDE), A,
                             random=np.random.RandomState(0), device=DEVICE)
        if not (wide.lines_width - wide.n_dynamic > 64).all():
            raise AssertionError('a wide scene has 64 live line slots or fewer')
        wide_poses = edges.random_poses(N_WIDE, A, 0, device=DEVICE)
        cases = (('crafted', crafted, lines, angles, positions, edges.RES),
                 ('wide', wide, wide.lines, *wide_poses, res))
        for name, scn, lines_, angles_, positions_, res_ in cases:
            args, kwargs, drawn = edges.mode_args(scn, lines_, angles_, positions_,
                                                  res_, hsw, radius, mode)
            skip = kwargs.get('skip_dyn', 0)
            out, nums = check_observe(torch, fused, render, args, kwargs, drawn)
            if nums['differing']:
                raise AssertionError(f'{mode} {name}: {nums}')
            if name == 'crafted' and not torch.equal(
                    out.indices[:, 0, edges.RES // 2], winners):
                raise AssertionError(f'{mode}: a crafted case picks another '
                                     'slot than it names')
            if name == 'wide' and not (out.indices - skip >= 64).any():
                raise AssertionError(f'{mode}: no wide-scene winner past '
                                     'the candidate mask')
            log(f'check {mode} on {name} scenes ({scn.n_envs} envs, '
                f'{int(scn.lines_width.max())} live slots at most, res {res_}): '
                f'{nums}')


def roofline_phase(torch, kernels, card):
    """K2 against its plain version on the JAX probe's input and on ragged
    sizes, bit for bit; its SASS; its times; then the three peak probes.
    Returns the peaks (published and measured), the roofline line's fields and
    K2's kernel entry."""
    from megastep_tpu_torch.perf import roofline

    ops = count(sass_opcodes(sass_text(kernels, 'vpu_probe')), ('FMUL', 'FFMA', 'FADD'))
    log(f'vpu_probe SASS: {ops}')
    if ops['FFMA'] or ops['FMUL'] < 16 * 8:
        raise AssertionError('the probe\'s multiply chains were fused or folded')
    text = sass_text(kernels, 'observe')
    ops = sass_opcodes(text)
    path = divide_fast_path(ops)
    log(f"observe SASS: {count(ops, ('MUFU.RCP', 'FCHK', 'FFMA', 'FMUL', 'FADD'))}; "
        f"an IEEE divide's fast path, {len(path)} instructions: {' '.join(path)} "
        f'(roofline.DIV_COST {roofline.DIV_COST})')
    observe_sass(text)

    g = torch.Generator(device=DEVICE)
    g.manual_seed(3)
    x = torch.randn(VPU_SHAPE, generator=g, device=DEVICE)
    flat = torch.randn(VPU_RAGGED, generator=g, device=DEVICE)
    err = 0.
    for case in (x, flat, flat[1:]):  # flat[1:] is not 16-byte aligned
        got = roofline.vpu_chain(case, VPU_CHAIN)
        want = roofline.vpu_chain_plain(case, VPU_CHAIN)
        torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f'vpu probe differs from plain at {tuple(case.shape)} '
                                 f'by up to {err}')
    del got, want
    log(f'check vpu probe at {VPU_SHAPE}, {VPU_RAGGED} and {VPU_RAGGED - 1} '
        f'elements (unaligned), chain {VPU_CHAIN}: bit for bit')
    ms = time_ms(torch, lambda: roofline.vpu_chain(x, VPU_CHAIN), 20)
    plain_ms = time_ms(torch, lambda: roofline.vpu_chain_plain(x, VPU_CHAIN), 3)
    bound_ms, bound_by = roofline.vpu_bound(x.numel(), VPU_CHAIN)
    log(f'vpu probe: {ms:.4f} ms/launch, plain {plain_ms:.3f} ms, bound '
        f'{bound_ms:.4f} ms ({bound_by}), '
        f'{VPU_CHAIN * x.numel() / ms / 1e9:.2f} T multiplies/s')
    del x, flat

    roofline.vpu_chain.launches = 0
    vpu = roofline.measure_vpu()
    launches = roofline.vpu_chain.launches
    if not launches:
        raise AssertionError('measure_vpu launched no probe kernel')
    hbm = roofline.measure_hbm()
    mxu = roofline.measure_mxu()
    peaks = dict(roofline.published_peaks(), card=card,
                 measured=dict(f32_ops=vpu, hbm_bytes=hbm, tc_flops=mxu))
    log(f'measured: f32 multiplies {vpu / 1e12:.3f} T/s ({launches} probe launches), '
        f'device memory {hbm / 1e9:.1f} GB/s, bf16 matmul {mxu / 1e12:.1f} TFLOP/s')
    line = {'card': card,
            'published': {'f32_flops_per_s': roofline.F32_OPS_PER_S,
                          'hbm_bytes_per_s': roofline.HBM_BYTES_PER_S,
                          'bf16_tc_flops_per_s': roofline.BF16_TC_FLOPS},
            'measured': {'f32_multiplies_per_s': vpu, 'hbm_bytes_per_s': hbm,
                         'bf16_matmul_flops_per_s': mxu},
            'div_cost': peaks['div_cost']}
    entry = {'name': 'vpu probe', 'route': 'cuda',
             'source': 'megastep_tpu_torch/csrc/vpu_probe.cu',
             'replaces': 'perf/roofline.py:85', 'launches': launches,
             'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
             'bound_ms': bound_ms, 'bound_by': bound_by,
             # No single PyTorch call computes this chain.
             'library_ms': None}
    return peaks, line, entry


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--profile', action='store_true',
                        help='also print device time by kernel over a few steps')
    opts = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    from megastep_tpu_torch import floorplans, kernels
    from megastep_tpu_torch.perf.roofline import nvidia_smi

    # 1. The card.
    card = nvidia_smi()
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}')
    log(card)

    # 2. Build the kernels from the sources in the checkout, one nvcc each, all
    # at once.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        texts = dict(zip(KERNELS, pool.map(kernels.build, KERNELS)))
    log(f'build: {time.perf_counter() - t0:.2f} s')
    for name, text in texts.items():
        if text is None:
            log(f'  {name}: already built')
        for line in (text or '').strip().splitlines():
            log(f'  {name}: {line}')

    # 3. The roofline: K2 and the peak probes.
    peaks, roofline_line, vpu_kernel = roofline_phase(torch, kernels, card)

    # 4. The two envs' main paths, each with its kernel checks and its roofline
    # table; bench.py's geometry list of 512 procedural floorplans, tiled.
    geoms = floorplans.sample(N_GEOMETRIES)
    torch.cuda.reset_peak_memory_stats()
    explorer, explorer_kernel, roofline_line['explorer'], explorer_profile = (
        explorer_phase(torch, opts, geoms, peaks))
    log(f'peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    torch.cuda.reset_peak_memory_stats()
    deathmatch, deathmatch_kernels, roofline_line['deathmatch'], deathmatch_profile = (
        deathmatch_phase(torch, opts, geoms, peaks))

    # 5. The observe kernel on crafted edge cases and on wide scenes, after
    # both throughput readings.
    edges_phase(torch)

    # After every throughput reading, so that the profiler's tracing cannot
    # touch a timed step.
    if opts.profile:
        explorer_profile()
        deathmatch_profile()

    for line in (explorer, deathmatch):
        log(json.dumps({'main_path': line}))
    log(json.dumps({'roofline': roofline_line}))
    log(json.dumps({'kernels': [explorer_kernel, *deathmatch_kernels, vpu_kernel]}))
    log(nvidia_smi())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
