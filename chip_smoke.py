"""Smoke run of the PyTorch/CUDA port (``megastep_tpu_torch``) on one NVIDIA GPU.

Builds the port's CUDA kernel from ``megastep_tpu_torch/csrc``, holds each of its
modes against its plain torch version on the card, and drives the engine's two
main paths at the benchmark's full size:

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
``{"kernels": [...]}`` JSON line, the card's name and power limit as
``nvidia-smi`` gives them, and last ``{"ok": true, "device": {...}}``. Without a
CUDA device it exits with code 2 and prints no result.
"""
import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np

N_ENVS, RES, SUBSAMPLE, STEPS = 16384, 256, 4, 32
DM_ENVS, DM_AGENTS, DM_RES = 16384, 4, 512  # agent-envs; scenes = envs / agents
DM_MODE_STEPS = 8          # steps of the draw_fused and fast_div runs
DEVICE = 'cuda'
N_CHECK = 2048             # Explorer envs of the kernel-vs-plain check
DM_CHECK = 2048            # Deathmatch agent-envs (512 scenes) of the same check
N_GEOMETRIES = 512         # floorplans, tiled over the scenes as bench.py does
BOUNDARY = 1e-6            # a second candidate this close to the tolerance edge
MAX_BOUNDARY_SHARE = 1e-4  # rays allowed to differ, all of them on that edge
TOL = dict(rtol=1e-5, atol=1e-6)

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: f32 operations per ray-line test in the kernel's line loop: 2 subtractions
#: for the offset, 3 cross products of 2 multiplies and a subtraction, the
#: absolute value, 2 divides and 4 compares; fast_div has 1 divide and 2
#: multiplies in place of the 2 divides.
OPS_PER_TEST = 18
OPS_PER_TEST_FAST_DIV = 19

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


def nvidia_smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    if out.returncode:
        raise RuntimeError(f'nvidia-smi failed: {out.stderr.strip()}')
    return out.stdout.strip().splitlines()[0]


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


def explorer_args(env, agents):
    scn, c = env.core.scenery, env.core
    return (scn.lines, scn.lines_width, scn.line_tex_starts, scn.line_tex_widths,
            env._table, agents.angles, agents.positions, c.res,
            c.half_screen_width, c.agent_radius)


def deathmatch_modes(torch, bake, render, env, agents):
    """Each Deathmatch mode's observe() arguments at ``agents``' poses, as
    ``(args, kwargs)``, and the drawn lines that every mode raycasts."""
    scn, c = env.core.scenery, env.core
    nd = scn.n_dynamic
    dyn_lines = render.draw_dynamic(scn, agents)
    dyn = bake.dynamic_texel_intensity_parts(scn, dyn_lines, scn.lines[:, nd:],
                                             k_max=env._k_lights)
    drawn = torch.cat([dyn_lines, scn.lines[:, nd:]], 1)
    rest = (scn.lines_width, scn.line_tex_starts, scn.line_tex_widths, env._table,
            agents.angles, agents.positions, c.res, c.half_screen_width,
            c.agent_radius)
    kw = dict(want_seen=False, baked_dyn=dyn)
    modes = {'patch': ((drawn, *rest), kw),
             'draw_model': ((scn.lines, *rest),
                            dict(kw, draw_model=scn.n_model_lines)),
             'fast_div': ((drawn, *rest), dict(kw, fast_div=True))}
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


def bound(scn, out, skip, ops_per_test=OPS_PER_TEST, t_dyn=0):
    """Least time the card could take for one observe on these inputs: bytes over
    the memory rate or operations over the f32 rate, whichever is larger."""
    N, A, R = out.indices.shape
    live = int((scn.lines_width - skip).clamp(min=0).sum())
    hits = int((out.indices >= 0).sum())
    nbytes = (live * 24            # live line slots: endpoints, texel start, width
              + N * A * 12         # pose: angle, x, y
              + N * t_dyn * 4      # this frame's model-texel intensities
              + hits * 32          # two 16-byte texel taps per hit ray
              + N * A * R * 20)    # index, distance, rgb per ray
    if 'seen' in out:
        nbytes += out.seen.numel() + hits  # seen mask zero-fill, one byte per hit
    ops = A * R * live * ops_per_test
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations',
            dict(bytes=nbytes, ops=ops, ray_line_tests=A * R * live))


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


def explorer_phase(torch, opts, geoms):
    """Explorer: kernel against plain at N_CHECK and N_ENVS envs, the main path
    at N_ENVS envs. Returns its main_path line and its kernel entry."""
    from megastep_tpu_torch import envs
    from megastep_tpu_torch.arrdict import arrdict
    from megastep_tpu_torch.ops import bake, fused, render

    env = envs.Explorer(N_CHECK, geometries=tiled(geoms, N_CHECK), res=RES,
                        subsample=SUBSAMPLE, random=np.random.RandomState(1),
                        device=DEVICE)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(1)
    state, _ = env.reset(g)
    angles = torch.rand(state.agents.angles.shape, generator=g, device=DEVICE) * 360 - 180
    agents = arrdict(angles=angles, positions=state.agents.positions)
    skip = env.core.scenery.n_dynamic
    kw = dict(skip_dyn=skip)
    _, small = check_observe(torch, fused, render, explorer_args(env, agents), kw)
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

    def step():
        nonlocal state, world
        actions = torch.randint(0, 7, (N_ENVS, 1), generator=g, device=DEVICE)
        state, world = env.step(state, arrdict(actions=actions), g)

    t0 = time.perf_counter()
    for _ in range(STEPS):
        step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / STEPS
    log(f'explorer throughput: {N_ENVS / step_s:.0f} env-steps/s '
        f'({1e3 * step_s:.3f} ms/step)')

    # The kernel and its plain version at the main path's shapes.
    args = explorer_args(env, state.agents)
    out, full = check_observe(torch, fused, render, args, kw)
    log(f'check explorer at {N_ENVS} envs: {full}')
    ms, plain_ms = time_observe(torch, fused, args, kw)
    bound_ms, bound_by, work = bound(scn, out, skip)
    log(f'observe (explorer): {ms:.4f} ms/launch, plain {plain_ms:.3f} ms, '
        f'bound {bound_ms:.4f} ms ({bound_by}; {work})')
    if opts.profile:
        profile_steps(torch, 'explorer', step, 1e3 * step_s)
    main = {'env': 'Explorer', 'n_envs': N_ENVS, 'res': RES, 'subsample': SUBSAMPLE,
            'steps': STEPS, 'env_steps_per_s': N_ENVS / step_s,
            'ms_per_step': 1e3 * step_s, 'build_s': build_s, 'bake_s': bake_s}
    return main, kernel_entry('explorer', launches, full['max_abs_err'], ms,
                              plain_ms, bound_ms, bound_by)


def deathmatch_phase(torch, opts, geoms):
    """Deathmatch: every mode against plain at DM_CHECK and DM_ENVS agent-envs,
    the main path at DM_ENVS, and short runs with draw_fused and fast_div.
    Returns its main_path line and its three kernel entries."""
    from megastep_tpu_torch import envs
    from megastep_tpu_torch.arrdict import arrdict
    from megastep_tpu_torch.ops import bake, fused, render

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
    modes, drawn = deathmatch_modes(torch, bake, render, env, agents)
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

    def step():
        nonlocal state
        actions = torch.randint(0, 7, (DM_ENVS, 1), generator=g, device=DEVICE)
        state, _ = env.step(state, arrdict(actions=actions), g)

    t0 = time.perf_counter()
    for _ in range(STEPS):
        step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / STEPS
    log(f'deathmatch throughput: {DM_ENVS / step_s:.0f} agent-steps/s '
        f'({1e3 * step_s:.3f} ms/step)')

    # Every mode and its plain version at the main path's shapes.
    modes, drawn = deathmatch_modes(torch, bake, render, env, state.agents)
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
        ops = OPS_PER_TEST_FAST_DIV if mode == 'fast_div' else OPS_PER_TEST
        bound_ms, bound_by, work = bound(scn, outs[mode], 0, ops,
                                         scn.n_dynamic_texels)
        timed[mode] = (ms, plain_ms, bound_ms, bound_by)
        log(f'observe ({mode}): {ms:.4f} ms/launch, plain {plain_ms:.3f} ms, '
            f'bound {bound_ms:.4f} ms ({bound_by}; {work})')
    del modes, drawn, outs
    log(f'peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    if opts.profile:
        profile_steps(torch, 'deathmatch', step, 1e3 * step_s)
    del env, state

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
            'ms_per_step': 1e3 * step_s, 'build_s': build_s, 'bake_s': bake_s,
            'rebake_ms': rebake_ms, 'shots': main_nums['shots'],
            'respawns': main_nums['respawns']}
    return main, [kernel_entry(m, launches[m], checks[m]['max_abs_err'], *timed[m])
                  for m in DM_MODES]


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

    # 1. The card.
    card = nvidia_smi()
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}')
    log(card)

    # 2. Build the kernel from the sources in the checkout.
    t0 = time.perf_counter()
    text = kernels.build('observe')
    log(f'build: {time.perf_counter() - t0:.2f} s'
        + ('' if text is not None else ' (already built)'))
    for line in (text or '').strip().splitlines():
        log(f'  observe: {line}')

    # 3. The two main paths, each with its kernel checks; bench.py's geometry
    # list of 512 procedural floorplans, tiled.
    geoms = floorplans.sample(N_GEOMETRIES)
    torch.cuda.reset_peak_memory_stats()
    explorer, explorer_kernel = explorer_phase(torch, opts, geoms)
    log(f'peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    torch.cuda.reset_peak_memory_stats()
    deathmatch, deathmatch_kernels = deathmatch_phase(torch, opts, geoms)

    for line in (explorer, deathmatch):
        log(json.dumps({'main_path': line}))
    log(json.dumps({'kernels': [explorer_kernel, *deathmatch_kernels]}))
    log(nvidia_smi())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
