"""Smoke run of the PyTorch/CUDA port (``megastep_tpu_torch``) on one NVIDIA GPU.

Builds the port's CUDA kernels from ``megastep_tpu_torch/csrc``, prints what
their SASS shows (for each instantiation of the observe kernel, its divides and
the straight path of its loop over the line slots), holds each of them (each
mode of the observe kernel, also on crafted edge cases and on scenes of more
than 64 live line slots) against its plain torch version on the card, and
drives the port's paths at full size:

- the roofline (``megastep_tpu_torch.perf.roofline``): the f32 multiply probe
  (K2) on the JAX probe's (64, 8, 256, 512) input, the device-memory and bf16
  matmul probes, and, in each env's phase below, the analytic table of its
  observe kernel;
- Explorer: 16,384 envs on procedural floorplans, res 256 pooled by 4 into RGB +
  depth + IMU, momentum movement and the seen-texel reward;
- Deathmatch: 16,384 agent-envs (4,096 scenes of 4 agents), res 512 pooled by 4
  into RGB + depth + IMU + health, momentum movement, the per-frame re-bake of
  the agent models (its kernel held against its plain version and timed
  beside it), the shoot test and respawn at death; then shorter runs of
  the same env with the in-kernel draw (``draw_fused``) and with ``fast_div``;
- Minimal: 16,384 envs, res 64, through the un-fused render (torch ops, no
  kernel) and simple movement; the card against the CPU at 64 envs, and its
  screen against the observe kernel's on the same agents;
- real floorplans: the five cubicasa fixtures (``tests/fixtures/cubicasa``),
  written into a dataset zip in a temporary cache directory and converted by
  the port's pipeline in a process pool; Explorer at 16,384 envs and
  Deathmatch at 16,384 agent-envs on them, each with its kernel against the
  plain version (Deathmatch past the kernel's 64-slot candidate mask);
- training (``megastep_tpu_torch.demo.train``, built through
  ``megastep_tpu_torch.perf.train_flagship``): the reference's flagship config,
  Explorer at 8,192 envs with a 256-wide LSTM agent, 32-step rollouts,
  16,384-sample minibatches, clipped AMSGrad and the KL stop, for 1 + 3
  chunks; its forward, gradients and an optimizer step on the card against
  the CPU; a chunk with the transformer core; Deathmatch training at 4,096
  agent-envs; and MatchCoin learning;
- the run directory (``megastep_tpu_torch.demo.train.train`` with
  ``megastep_tpu_torch.rebar`` and ``megastep_tpu_torch.parallel.checkpoint``):
  ``train()`` on the flagship env for 2 chunks with stats, logs, stored weights
  and a full-carry checkpoint, each read back; a restore that equals the saved
  carry tensor for tensor, a continued run, a resume from the stored weights;
  then a profiled MatchCoin chunk and a SIGINT deferred to a chunk boundary;
- ``demo()`` (``megastep_tpu_torch.demo.train.demo``): the agent the run
  directory stored, 256 wide, rolled out on the flagship env for 32 frames,
  then a fresh 256-wide agent on Deathmatch at 4,096 agent-envs for 16; each
  step's snapshot checked against its observation and, where this machine has
  matplotlib and an encoder backend (Pillow, PyAV or ffmpeg), plotted in the
  port's process pool and encoded (else a recorder of the snapshots stands in
  for the encoder, and the ``demo`` line says what is missing); the kernel
  launch of one demo step of each held against its plain version;
- the multi-device layer (``megastep_tpu_torch.parallel``): the flagship
  config's sharded train step over a one-rank NCCL group, its first chunk
  held against the single-device step from the same start; then two gloo
  ranks spawned on the same card (NCCL refuses two ranks on one GPU), each
  the flagship config on half of the 8,192 envs and then a scene-sharded
  Deathmatch on half of 4,096 agent-envs, their parameters and metrics
  bit-equal across the ranks after every chunk, the collectives of every
  chunk the design's list, and each rank's observe launch against its plain
  version.

Any failed phase raises, and the script then exits non-zero without its last
line. Run it from the repository root:

    python3 chip_smoke.py            # add --profile for a per-kernel breakdown

It prints progress lines, one ``{"main_path": {...}}`` JSON line per env and
set of plans, a ``{"train": {...}}`` line, a ``{"roofline": {...}}`` line, a
``{"run_dir": {...}}`` line, a ``{"demo": {...}}`` line, a ``{"parallel":
{...}}`` line, a ``{"kernels": [...]}`` JSON line, the card's
name and power limit as ``nvidia-smi`` gives them, and last ``{"ok": true,
"device": {...}}``. Without a CUDA device it exits with code 2 and prints no
result.
"""
import argparse
import contextlib
import functools
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
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
REBAKE_TOL = dict(rtol=1e-6, atol=1e-6)
VPU_SHAPE, VPU_CHAIN = (64, 8, 256, 512), 256  # the JAX probe's defaults
VPU_RAGGED = 4 * 100_003 + 1  # elements: not whole float4s
KERNELS = ('observe', 'vpu_probe')
MIN_ENVS, MIN_CHECK, MIN_SEED = 16384, 64, 0   # Minimal: main path, card vs CPU
REAL = 'cubicasa fixtures'  # the real plans, tests/fixtures/cubicasa/*/model.svg
FIXTURES = Path(__file__).resolve().parent / 'tests' / 'fixtures' / 'cubicasa'
PLANS = ('apartment_a', 'duplex_e', 'loft_d', 'rowhouse_c', 'studio_b')
REAL_DM_STEPS = 8          # Deathmatch on the real plans: steps of its run
# The train phase: the flagship config (megastep_tpu/demo/train.py:265-267).
TRAIN_ENVS, TRAIN_BUFFER, TRAIN_BATCH, TRAIN_WIDTH = 8192, 32, 16384, 256
TRAIN_CHUNKS = 3           # timed, after one warm-up chunk
CHECK_ENVS = 512           # env columns of the card-against-CPU minibatch
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_F32_FACTOR = 4       # the card's f32 gradients against the CPU's, both from float64
TF_ENVS, TF_BATCH = 2048, 4096           # the transformer core's chunk
DM_TRAIN_ENVS, DM_TRAIN_BATCH, DM_TRAIN_CHUNKS = 4096, 8192, 2
COIN_ENVS, COIN_WIDTH, COIN_LR, COIN_BUFFER, COIN_CHUNKS = 32, 16, 3e-3, 8, 30
SIGINT_AFTER_S = .5        # the run-directory phase's SIGINT, after the first env step
# The demo phase: demo() on the flagship env with its stored agent, then on
# Deathmatch with a fresh 256-wide agent.
DEMO_LENGTH, DEMO_D = 32, 1                  # frames; the env recorded
DM_DEMO_ENVS, DM_DEMO_LENGTH, DM_DEMO_D = 4096, 16, 0
DEMO_CHECK_STEP = 1        # the demo step whose observe launch is held against plain
# The parallel phase: the flagship config through the sharded train step, over
# a one-rank NCCL group, then over two gloo ranks that share the card (NCCL
# refuses two ranks on one GPU); then Deathmatch at PAR_DM_ENVS agent-envs
# over the two ranks.
WORLD1_BACKEND, PAR_WORLD, PAR_CHUNKS = 'nccl', 2, 2   # PAR_CHUNKS timed, after a warm-up one
PAR_DM_ENVS, PAR_DM_BUFFER, PAR_DM_BATCH = 4096, 8, 8192

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


def check_observe(torch, fused, render, args, kwargs, drawn=None, want=None):
    """The observe kernel against its plain version on the same inputs (or
    against ``want``, another reference in the plain version's layout).

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
    want = fused.observe_plain(*args, **kwargs) if want is None else want
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


def kernel_entry(mode, launches, err, ms, plain_ms, bound_ms, bound_by, plans=None):
    # No single PyTorch call computes this function, so library_ms is null.
    entry = {'name': f'observe ({mode}{", " + plans if plans else ""})', 'route': 'cuda',
             'source': 'megastep_tpu_torch/csrc/observe.cu',
             'replaces': REPLACES[mode], 'launches': launches, 'max_abs_err': err,
             'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
             'bound_by': bound_by, 'library_ms': None}
    if plans:
        entry['plans'] = plans
    return entry


def explorer_phase(torch, opts, geoms, peaks, plans=None):
    """Explorer: kernel against plain at N_CHECK and N_ENVS envs, the main path
    at N_ENVS envs, then its roofline table at ``peaks``. Returns its main_path
    line, its kernel entry, its table, and with ``--profile`` a callable that
    profiles its step. ``plans`` names the geometries where they are not the
    procedural ones, in the logs, the main_path line and the kernel entry."""
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
    where = f'explorer on {plans}' if plans else 'explorer'
    skip = env.core.scenery.n_dynamic
    _, small = check_observe(torch, fused, render, *env.observe_args(agents))
    log(f'check {where} at {N_CHECK} envs: {small}')
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
    log(f'{where}: {N_ENVS} envs built in {build_s:.2f} s (bake alone {bake_s:.2f} s); '
        f'lines {tuple(scn.lines.shape)} ({int(scn.lines_width.max())} live at most) '
        f'texels {tuple(scn.baked.shape)} lights {tuple(scn.lights.shape)}')

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
    log(f'{where} main path: reset + {STEPS} steps, observe kernel launches '
        f'{launches}, mean reward {float(world.reward.mean()):.4f}, '
        f'mean potential {float(state.potential.mean()):.1f}')

    step = stepper(torch, env, state, g)
    windows, step_s, state = timed_windows(torch, step)
    log(f'{where} throughput: {N_ENVS / step_s:.0f} env-steps/s '
        f'({1e3 * step_s:.3f} ms/step over {len(windows)} windows of {STEPS} '
        f'steps: {", ".join(f"{1e3 * w:.3f}" for w in windows)})')

    # The kernel and its plain version at the main path's shapes.
    args, kw = env.observe_args(state.agents)
    out, full = check_observe(torch, fused, render, args, kw)
    log(f'check {where} at {N_ENVS} envs: {full}')
    ms, plain_ms = time_observe(torch, fused, args, kw)
    bound_ms, bound_by, work = roofline.bound(scn, out, skip)
    log(f'observe ({where}): {ms:.4f} ms/launch, plain {plain_ms:.3f} ms, '
        f'bound {bound_ms:.4f} ms ({bound_by}; {work})')
    profile = (functools.partial(profile_steps, torch, 'explorer', step, 1e3 * step_s)
               if opts.profile else None)
    table = roofline.analytic('explorer', env, 1e3 * step_s, peaks)
    main = {'env': 'Explorer', 'n_envs': N_ENVS, 'res': RES, 'subsample': SUBSAMPLE,
            'steps': STEPS, 'env_steps_per_s': N_ENVS / step_s,
            'ms_per_step': 1e3 * step_s, 'ms_per_step_windows': [1e3 * w for w in windows],
            'build_s': build_s, 'bake_s': bake_s}
    if plans:
        main.update(plans=plans, line_slots=scn.lines.shape[1],
                    live_slots_max=int(scn.lines_width.max()), texels=scn.baked.shape[1])
    return main, kernel_entry('explorer', launches, full['max_abs_err'], ms,
                              plain_ms, bound_ms, bound_by, plans), table, profile


def deathmatch_env(geoms, n, seed, **kwargs):
    """Deathmatch at ``n`` agent-envs on ``geoms`` tiled over its scenes."""
    from megastep_tpu_torch import envs
    return envs.Deathmatch(n, n_agents=DM_AGENTS, geometries=tiled(geoms, n // DM_AGENTS),
                           res=DM_RES, subsample=SUBSAMPLE,
                           random=np.random.RandomState(seed), device=DEVICE, **kwargs)


def deathmatch_run(torch, env, steps, seed, keep=0):
    """Reset + ``steps`` steps of a DM_ENVS Deathmatch from generator seed
    ``seed``, counting the observe and re-bake kernels' launches from 0;
    checks each world and returns the last state, the run's numbers and the
    first ``keep`` worlds."""
    from megastep_tpu_torch.arrdict import arrdict
    from megastep_tpu_torch.ops import fused
    ds = DM_RES // SUBSAMPLE
    shapes = dict(rgb=(DM_ENVS, 1, 3, 1, ds), d=(DM_ENVS, 1, 1, 1, ds),
                  imu=(DM_ENVS, 1, 3), health=(DM_ENVS, 1, 1))
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    fused.observe.launches = fused.rebake.launches = 0
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
    nums = dict(launches=fused.observe.launches,
                rebake_launches=fused.rebake.launches, shots=int(shots),
                respawns=int(respawns))
    return state, nums, kept


def check_launches(nums, steps, where='main path'):
    """One observe and one re-bake launch in reset and in each step."""
    for k, name in (('launches', 'observe'), ('rebake_launches', 're-bake')):
        if nums[k] != 1 + steps:
            raise AssertionError(f'{where}: {name} kernel launched {nums[k]} times '
                                 f'in reset + {steps} steps')


def check_rebake(torch, env, agents, launches):
    """The re-bake kernel against its plain version at ``agents``' poses:
    every texel's intensity within REBAKE_TOL (the lights are summed in
    another order). Then the kernel's time (20 launches), the draw's and the
    kernel's together, the plain version's (3) and its bound. Returns its
    kernel entry and the draw + kernel ms."""
    from megastep_tpu_torch.ops import bake, fused, render
    from megastep_tpu_torch.perf import roofline
    scn = env.core.scenery
    walls = scn.lines[:, scn.n_dynamic:]
    dyn = render.draw_dynamic(scn, agents)
    k = env._k_lights
    got = fused.rebake(scn, dyn, walls, k_max=k)
    want = bake.dynamic_texel_intensity_parts(scn, dyn, walls, k_max=k)
    err = float((got - want).abs().max())
    off = int((~torch.isclose(got, want, **REBAKE_TOL)).sum())
    if off:
        raise AssertionError(f're-bake: {off} texels off the plain version, by up '
                             f'to {err}')
    ms = time_ms(torch, lambda: fused.rebake(scn, dyn, walls, k_max=k), 20)
    draw_ms = time_ms(torch, lambda: fused.rebake(
        scn, render.draw_dynamic(scn, agents), walls, k_max=k), 20)
    plain_ms = time_ms(torch, lambda: bake.dynamic_texel_intensity_parts(
        scn, dyn, walls, k_max=k), 3)
    bound_ms, bound_by, work = roofline.rebake_bound(scn, k)
    log(f're-bake at {env.n_envs} agent-envs: {got.numel()} texels within '
        f'{REBAKE_TOL} of plain (max abs err {err:.3g}); {ms:.4f} ms/launch, with '
        f'the draw {draw_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} '
        f'ms ({bound_by}; {work}); {launches} launches in the main path')
    entry = {'name': 're-bake', 'route': 'cuda',
             'source': 'megastep_tpu_torch/csrc/observe.cu',
             'replaces': None, 'launches': launches, 'max_abs_err': err, 'ms': ms,
             'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bound_by': bound_by,
             # No single PyTorch call computes this function.
             'library_ms': None}
    return entry, draw_ms


def deathmatch_phase(torch, opts, geoms, peaks):
    """Deathmatch: every mode against plain at DM_CHECK and DM_ENVS agent-envs,
    the main path at DM_ENVS, the re-bake kernel against its plain version,
    its roofline table at ``peaks``, and short runs with draw_fused and
    fast_div. Returns its main_path line, its four kernel entries (the three
    modes and the re-bake), its table, and with ``--profile`` a callable that
    profiles its step."""
    from megastep_tpu_torch.arrdict import arrdict
    from megastep_tpu_torch.ops import bake, fused, render
    from megastep_tpu_torch.perf import roofline
    from megastep_tpu_torch.perf.step_rate import timed_windows

    build = functools.partial(deathmatch_env, geoms)
    run = functools.partial(deathmatch_run, torch)

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

    state, main_nums, ref = run(env, STEPS, 0, keep=1 + DM_MODE_STEPS)
    check_launches(main_nums, STEPS)
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
    # The step's other kernel: the per-frame re-bake of the model texels.
    rebake_kernel, rebake_ms = check_rebake(torch, env, state.agents,
                                            main_nums['rebake_launches'])
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
        check_launches(nums, DM_MODE_STEPS, mode)
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
            'draw_rebake_ms': rebake_ms, 'shots': main_nums['shots'],
            'respawns': main_nums['respawns']}
    return main, [*(kernel_entry(m, launches[m], checks[m]['max_abs_err'], *timed[m])
                    for m in DM_MODES), rebake_kernel], table, profile


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


def minimal_phase(torch, opts):
    """Minimal: the un-fused render (draw, raycast and shade as torch ops, as
    the JAX Minimal renders with XLA ops) and simple movement. The card against
    the CPU at MIN_CHECK envs on the same scenery seed, spawn slots and actions;
    the main path at MIN_ENVS envs, reset + STEPS steps of random actions, in
    which the observe kernel must not launch; its throughput; then the
    un-fused screen of the main path's last agents against the observe
    kernel's (K1a, on the static lines past the agent model) by
    ``check_observe``'s edge rule. Returns its main_path line and, with
    ``--profile``, a callable that profiles its step."""
    from megastep_tpu_torch import envs, modules
    from megastep_tpu_torch.arrdict import arrdict
    from megastep_tpu_torch.ops import fused, render
    from megastep_tpu_torch.perf.step_rate import timed_windows

    # The scenery's textures and lights come from numpy's global state, as in
    # the JAX package: each build is seeded the same.
    cpu_gen = torch.Generator().manual_seed(1)
    choices = torch.randint(0, 100, (MIN_CHECK, 1), generator=cpu_gen)
    actions = torch.randint(0, 7, (STEPS, MIN_CHECK, 1), generator=cpu_gen)
    obs = {}
    for dev in (DEVICE, 'cpu'):
        np.random.seed(MIN_SEED)
        env = envs.Minimal(MIN_CHECK, device=dev)
        state, world = env.reset(choices.to(dev))
        seq = [world.obs]
        for a in actions:
            state, world = env.step(state, arrdict(actions=a.to(dev)))
            seq.append(world.obs)
        obs[dev] = torch.stack(seq).cpu()
    card_err = float((obs[DEVICE] - obs['cpu']).abs().max())
    if not torch.allclose(obs[DEVICE], obs['cpu'], **TOL):
        raise AssertionError(f'minimal: card and CPU observations differ by up to '
                             f'{card_err} (rtol=1e-5, atol=1e-6)')
    log(f'check minimal card against CPU at {MIN_CHECK} envs, reset + {STEPS} steps: '
        f'max abs error {card_err}')
    del env, state, world, obs

    t0 = time.perf_counter()
    np.random.seed(MIN_SEED)
    env = envs.Minimal(MIN_ENVS, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    c = env.core
    log(f'minimal: {MIN_ENVS} envs built in {build_s:.2f} s; res {c.res}, lines '
        f'{tuple(c.scenery.lines.shape)}')

    g = torch.Generator(device=DEVICE)
    g.manual_seed(0)
    fused.observe.launches = 0
    state, world = env.reset(g)
    shape = (MIN_ENVS, 1, 3, 1, c.res)
    ok = torch.ones((), dtype=torch.bool, device=DEVICE)
    for _ in range(STEPS):
        actions = torch.randint(0, 7, (MIN_ENVS, 1), generator=g, device=DEVICE)
        state, world = env.step(state, arrdict(actions=actions), g)
        if tuple(world.obs.shape) != shape:
            raise AssertionError(f'minimal obs has shape {tuple(world.obs.shape)}')
        ok &= torch.isfinite(world.obs).all() & ((world.obs >= 0) & (world.obs <= 1)).all()
        ok &= ((state.progress >= 0) & (state.progress <= 1)).all()
    torch.cuda.synchronize()
    if fused.observe.launches:
        raise AssertionError(f'the un-fused path launched the observe kernel '
                             f'{fused.observe.launches} times')
    if not bool(ok):
        raise AssertionError('minimal observations or progress out of range')
    log(f'minimal main path: reset + {STEPS} steps, mean observation '
        f'{float(world.obs.mean()):.4f}, mean progress {float(state.progress.mean()):.4f}')

    step = stepper(torch, env, state, g)
    windows, step_s, state = timed_windows(torch, step)
    log(f'minimal throughput: {MIN_ENVS / step_s:.0f} env-steps/s '
        f'({1e3 * step_s:.3f} ms/step over {len(windows)} windows of {STEPS} '
        f'steps: {", ".join(f"{1e3 * w:.3f}" for w in windows)})')

    # The un-fused render against the kernel on the same agents.
    scn, agents = c.scenery, state.agents
    r = modules.render(c, agents)
    want = arrdict(indices=r.indices[:, :, 0], distances=r.distances[:, :, 0],
                   screen=r.screen[:, :, :, 0])
    args = (scn.lines, scn.lines_width, scn.line_tex_starts, scn.line_tex_widths,
            render.pack_table(scn), agents.angles, agents.positions, c.res,
            c.half_screen_width, c.agent_radius)
    _, unfused = check_observe(torch, fused, render, args,
                               dict(skip_dyn=scn.n_dynamic, want_seen=False), want=want)
    log(f'check minimal un-fused render against the observe kernel at {MIN_ENVS} '
        f'envs: {unfused}')
    profile = (functools.partial(profile_steps, torch, 'minimal', step, 1e3 * step_s)
               if opts.profile else None)
    main = {'env': 'Minimal', 'n_envs': MIN_ENVS, 'res': c.res, 'subsample': 1,
            'steps': STEPS, 'env_steps_per_s': MIN_ENVS / step_s,
            'ms_per_step': 1e3 * step_s, 'ms_per_step_windows': [1e3 * w for w in windows],
            'build_s': build_s, 'observe_launches': 0,
            'card_vs_cpu_max_abs_err': card_err, 'unfused_vs_kernel': unfused}
    return main, profile


def real_plans(torch):
    """The five cubicasa fixture plans, as the port's pipeline converts them:
    written into a dataset zip in the cache directory (``MEGASTEP_TPU_CACHE``,
    set before the port was imported) and converted in a process pool while
    the card is in use. Each must equal a conversion in this process."""
    import zipfile
    from megastep_tpu_torch import cubicasa

    root = Path(os.environ['MEGASTEP_TPU_CACHE']) / 'cubicasa'
    if cubicasa.ROOT != root:
        raise AssertionError(f'cubicasa.ROOT is {cubicasa.ROOT}, not {root}')
    root.mkdir(parents=True, exist_ok=True)
    svgs = {name: (FIXTURES / name / 'model.svg').read_text() for name in PLANS}
    with zipfile.ZipFile(root / 'cubicasa5k.zip', 'w') as z:
        for name, svg in svgs.items():
            z.writestr(f'cubicasa5k/{name}/model.svg', svg)
    t0 = time.perf_counter()
    plans = cubicasa.geometry_data(backend='process')
    convert_s = time.perf_counter() - t0
    if len(plans) != len(PLANS) or not cubicasa.cache_path().exists():
        raise AssertionError(f'{len(plans)} plans converted, cache '
                             f'{cubicasa.cache_path().exists()}')
    for g in plans:
        ref = cubicasa.svg_geometry(g.id, svgs[g.id.split('/')[1]])
        if not all(np.array_equal(g[k], ref[k]) for k in ('walls', 'lights', 'masks')):
            raise AssertionError(f'{g.id}: the forked conversion differs')
    log(f'cubicasa: {len(plans)} fixture plans converted in {convert_s:.2f} s by '
        f'a process pool; walls {[len(g.walls) for g in plans]}, masks '
        f'{[g.masks.shape for g in plans]}')
    return plans, convert_s


def deathmatch_real(torch, geoms):
    """Deathmatch on real plans: K1b ('patch') against its plain version at
    DM_CHECK and DM_ENVS agent-envs, where a scene's live line slots must
    exceed the kernel's 64-slot candidate mask; the main path, reset +
    REAL_DM_STEPS steps, with its respawns; its throughput over windows of
    REAL_DM_STEPS steps. Returns its main_path line and kernel entry."""
    from megastep_tpu_torch.arrdict import arrdict
    from megastep_tpu_torch.ops import fused, render
    from megastep_tpu_torch.perf import roofline
    from megastep_tpu_torch.perf.step_rate import timed_windows

    env = deathmatch_env(geoms, DM_CHECK, 1)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(1)
    state, _ = env.reset(g)
    angles = torch.rand(state.agents.angles.shape, generator=g, device=DEVICE) * 360 - 180
    args, kw = env.observe_args(arrdict(angles=angles, positions=state.agents.positions))
    _, small = check_observe(torch, fused, render, args, kw)
    log(f'check patch on {REAL} at {DM_CHECK} agent-envs: {small}')
    del env, state, args

    t0 = time.perf_counter()
    env = deathmatch_env(geoms, DM_ENVS, 0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    scn = env.core.scenery
    live = int(scn.lines_width.max())
    log(f'deathmatch on {REAL}: {DM_ENVS} agent-envs built in {build_s:.2f} s; lines '
        f'{tuple(scn.lines.shape)} ({scn.n_dynamic} dynamic, {live} live at most) '
        f'texels {tuple(scn.baked.shape)} lights {tuple(scn.lights.shape)}')
    if live <= 64:
        raise AssertionError(f'{live} live line slots: the plans do not pass the '
                             'kernel\'s 64-slot candidate mask')

    state, nums, _ = deathmatch_run(torch, env, REAL_DM_STEPS, 0)
    check_launches(nums, REAL_DM_STEPS, REAL)
    log(f'deathmatch on {REAL} main path: reset + {REAL_DM_STEPS} steps, {nums}')
    g = torch.Generator(device=DEVICE)
    g.manual_seed(2)
    step = stepper(torch, env, state, g)
    windows, step_s, state = timed_windows(torch, step, steps=REAL_DM_STEPS)
    log(f'deathmatch on {REAL} throughput: {DM_ENVS / step_s:.0f} agent-steps/s '
        f'({1e3 * step_s:.3f} ms/step over {len(windows)} windows of {REAL_DM_STEPS} '
        f'steps: {", ".join(f"{1e3 * w:.3f}" for w in windows)})')

    args, kw = env.observe_args(state.agents)
    out, full = check_observe(torch, fused, render, args, kw)
    log(f'check patch on {REAL} at {DM_ENVS} agent-envs: {full}')
    ms, plain_ms = time_observe(torch, fused, args, kw)
    bound_ms, bound_by, work = roofline.bound(scn, out, 0, scn.n_dynamic_texels)
    log(f'observe (patch, {REAL}): {ms:.4f} ms/launch, plain {plain_ms:.3f} ms, '
        f'bound {bound_ms:.4f} ms ({bound_by}; {work})')
    main = {'env': 'Deathmatch', 'plans': REAL, 'agent_envs': DM_ENVS,
            'scenes': scn.n_envs, 'agents': DM_AGENTS, 'res': DM_RES,
            'subsample': SUBSAMPLE, 'steps': REAL_DM_STEPS,
            'agent_steps_per_s': DM_ENVS / step_s, 'ms_per_step': 1e3 * step_s,
            'ms_per_step_windows': [1e3 * w for w in windows], 'build_s': build_s,
            'line_slots': scn.lines.shape[1], 'live_slots_max': live,
            'texels': scn.baked.shape[1], 'shots': nums['shots'],
            'respawns': nums['respawns']}
    return main, kernel_entry('patch', nums['launches'], full['max_abs_err'], ms,
                              plain_ms, bound_ms, bound_by, REAL)


def profile_train(torch, run, rollout_ms, learner_ms):
    """Device time by kernel over one rollout and one learner call of the
    flagship config's ``run``, against the timed chunks' mean CUDA-event spans
    of each (``rollout_ms``, ``learner_ms``)."""
    import importlib
    train = importlib.import_module('megastep_tpu_torch.demo.train')
    carry, out = run.carry, {}

    def roll():
        out['chunk'] = train.rollout(run.env, run.agent, carry.env_state, carry.world,
                                     carry.agent_state, run.generator, TRAIN_BUFFER)[3]
    profile_steps(torch, 'train rollout (a chunk)', roll, rollout_ms, n=1)
    width = TRAIN_BATCH // TRAIN_BUFFER
    perm = torch.randperm(TRAIN_ENVS, generator=run.generator, device=DEVICE)
    batches = perm[:TRAIN_ENVS // width * width].reshape(-1, width)
    profile_steps(torch, 'train learner (a chunk)',
                  lambda: train.learn(run.agent, run.opt, out['chunk'], carry.agent_state,
                                      batches),
                  learner_ms, n=1)


def train_phase(torch, opts, geoms, card):
    """The training path: the flagship config's main path (init_carry's reset,
    one warm-up chunk, TRAIN_CHUNKS timed ones), its forward and an optimizer
    step on the card against the CPU, a transformer chunk, Deathmatch training
    and MatchCoin learning. Returns the ``train`` line, and with ``--profile``
    a callable that profiles the flagship config's rollout and learner, and the
    flagship config's env."""
    import importlib
    from megastep_tpu_torch.ops import fused
    from megastep_tpu_torch.perf import grad_noise, train_flagship
    from megastep_tpu_torch.rebar import fsm
    from megastep_tpu_torch.models import Agent
    train = importlib.import_module('megastep_tpu_torch.demo.train')

    def finite(history, what):
        for m in history:
            if not train.is_finite(m) or m['minibatches'] < 1:
                raise AssertionError(f'{what}: a chunk ran no minibatch or has a '
                                     f'metric that is not finite: {m}')

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fused.observe.launches = 0
    run = train_flagship.build('explorer', TRAIN_ENVS, TRAIN_BUFFER, TRAIN_BATCH, TRAIN_WIDTH,
                               geometries=geoms, device=DEVICE, res=RES, subsample=SUBSAMPLE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    counts = [fused.observe.launches]
    chunks = []
    for _ in range(1 + TRAIN_CHUNKS):
        chunks.append(train_flagship.timed_chunks(run, 1))
        counts.append(fused.observe.launches)
    launches = fused.observe.launches
    want = [1 + TRAIN_BUFFER * i for i in range(2 + TRAIN_CHUNKS)]
    if counts != want:
        raise AssertionError(f'observe kernel launches after the reset and each chunk '
                             f'{counts}, not {want}')
    history = [c[0][0] for c in chunks]
    finite(history, 'explorer training')
    timed = chunks[1:]
    seconds = sum(c[1] for c in timed)
    rollout_ms = [c[2][0] for c in timed]
    learner_ms = [c[3][0] for c in timed]
    rate = TRAIN_ENVS * TRAIN_BUFFER * TRAIN_CHUNKS / seconds
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f'train explorer: {TRAIN_ENVS} envs built in {build_s:.2f} s; observe kernel '
        f'launches {launches}; {rate:.0f} env-steps/s over {TRAIN_CHUNKS} chunks '
        f'({1e3 * seconds / TRAIN_CHUNKS:.1f} ms a chunk; rollout '
        f'{", ".join(f"{ms:.1f}" for ms in rollout_ms)} ms, learner '
        f'{", ".join(f"{ms:.1f}" for ms in learner_ms)} ms); minibatches '
        f'{[int(m["minibatches"]) for m in history]}; last chunk {history[-1]}')

    # The card against the CPU on one (T, CHECK_ENVS) minibatch: the forward,
    # the loss, the gradients, and the parameters after one optimizer step from
    # the trained optimizer's state. One step moves a parameter by at most lr,
    # so the parameters alone would not show an error in the backward. The
    # gradients are held against the CPU's float64 step: the card's and the
    # CPU's f32 gradients each lie up to ~1e-6 from it, often more than 1e-5
    # times the largest gradient, and not on the same elements
    # (perf/grad_noise.py). So the card's may lie at most GRAD_F32_FACTOR times
    # as far from it as the CPU's f32 do, or 1e-5 times the largest gradient.
    agent, opt, carry = run.agent, run.opt, run.carry
    state0 = carry.agent_state.map(lambda x: x[:CHECK_ENVS])
    _, _, _, chunk = train.rollout(run.env, agent, carry.env_state, carry.world,
                                   carry.agent_state, run.generator, TRAIN_BUFFER)
    batch = chunk.map(lambda x: x[:, :CHECK_ENVS].contiguous())
    del chunk
    steps = []
    for device, f64 in ((DEVICE, False), ('cpu', False), ('cpu', True)):
        t0 = time.perf_counter()
        steps.append((grad_noise.step_results(agent, opt, batch, state0, device, f64=f64,
                                              forward=not f64),
                       time.perf_counter() - t0))
    (card_r, card_s), (cpu_r, cpu_s), (exact, f64_s) = steps
    exact = exact['grads']
    errs = {'grads_cpu_vs_f64': grad_noise.max_diff(cpu_r['grads'], exact)}
    grad_scale = max(float(g.abs().max()) for g in cpu_r['grads'])
    for k in ('logits', 'value', 'loss', 'grads', 'params'):
        if k == 'grads':
            pairs = [(x, y.float()) for x, y in zip(card_r[k], exact)]
            tol = dict(TRAIN_TOL, atol=max(TRAIN_TOL['atol'] * grad_scale,
                                           GRAD_F32_FACTOR * errs['grads_cpu_vs_f64']))
        else:
            listed = k == 'params'
            pairs = list(zip(card_r[k], cpu_r[k])) if listed else [(card_r[k], cpu_r[k])]
            tol = TRAIN_TOL
        errs[k] = max(float((x - y).abs().max()) for x, y in pairs)
        if not all(torch.allclose(x, y, **tol) for x, y in pairs):
            what = 'the float64 step' if k == 'grads' else 'the CPU'
            raise AssertionError(f'the card differs from {what} in {k} by up to {errs[k]} '
                                 f'(rtol {tol["rtol"]}, atol {tol["atol"]})')
    errs['grad_scale'] = grad_scale
    log(f'train card against CPU at T={TRAIN_BUFFER}, B={CHECK_ENVS}: max abs errors {errs} '
        f'(grads: the card against the float64 step); steps {card_s:.2f} s on the card, '
        f'{cpu_s:.2f} s on the CPU, {f64_s:.2f} s in float64 on the CPU')
    del agent, opt, carry, card_r, cpu_r, exact, steps, batch, state0

    profile = (functools.partial(profile_train, torch, run, float(np.mean(rollout_ms)),
                                 float(np.mean(learner_ms))) if opts.profile else None)
    flagship_env = run.env
    del run

    # The transformer core at full width.
    fused.observe.launches = 0
    run = train_flagship.build('explorer', TF_ENVS, TRAIN_BUFFER, TF_BATCH, TRAIN_WIDTH,
                               core='transformer', geometries=geoms, device=DEVICE,
                               res=RES, subsample=SUBSAMPLE)
    tf_history, tf_s, tf_rollout, tf_learner = train_flagship.timed_chunks(run, 1)
    finite(tf_history, 'transformer training')
    if fused.observe.launches != 1 + TRAIN_BUFFER:
        raise AssertionError(f'transformer run: {fused.observe.launches} observe launches')
    log(f'train transformer: {TF_ENVS} envs, one chunk in {tf_s:.2f} s (rollout '
        f'{tf_rollout[0]:.1f} ms, learner {tf_learner[0]:.1f} ms); {tf_history[-1]}')
    del run

    # Deathmatch training at train_flagship.py's documented config: K1b in the
    # rollout, under the learner.
    fused.observe.launches = 0
    run = train_flagship.build('deathmatch', DM_TRAIN_ENVS, TRAIN_BUFFER, DM_TRAIN_BATCH,
                               TRAIN_WIDTH, geometries=geoms, device=DEVICE)
    dm_warm = train_flagship.timed_chunks(run, 1)[0]  # a warm-up chunk, as Explorer's
    dm_history, dm_s, dm_rollout, dm_learner = train_flagship.timed_chunks(run, DM_TRAIN_CHUNKS)
    finite(dm_warm + dm_history, 'deathmatch training')
    dm_launches = fused.observe.launches
    if dm_launches != 1 + TRAIN_BUFFER * (1 + DM_TRAIN_CHUNKS):
        raise AssertionError(f'deathmatch training: {dm_launches} observe launches')
    dm_rate = DM_TRAIN_ENVS * TRAIN_BUFFER * DM_TRAIN_CHUNKS / dm_s
    log(f'train deathmatch: {DM_TRAIN_ENVS} agent-envs, {dm_rate:.0f} agent-steps/s over '
        f'{DM_TRAIN_CHUNKS} chunks after a warm-up one (rollout '
        f'{", ".join(f"{ms:.1f}" for ms in dm_rollout)} '
        f'ms, learner {", ".join(f"{ms:.1f}" for ms in dm_learner)} ms); observe kernel '
        f'launches {dm_launches}; last chunk {dm_history[-1]}')
    del run

    # Learning on the card: MatchCoin, as tests/test_train.py trains it.
    env = fsm.MatchCoin(COIN_ENVS, device=DEVICE)
    agent = Agent(env.obs_space, env.action_space, width=COIN_WIDTH,
                  generator=torch.Generator().manual_seed(0)).to(DEVICE)
    opt = train.optimizer(agent.parameters(), COIN_LR, max_grad_norm=None)
    g = torch.Generator(DEVICE)
    g.manual_seed(0)
    carry = train.init_carry(env, agent, opt, g)
    step = train.make_train_step(env, COIN_BUFFER, COIN_BUFFER * COIN_ENVS)
    rewards = []
    for _ in range(COIN_CHUNKS):
        carry, m = step(carry, g)
        rewards.append(m['traj_reward'])
    coin = float(np.mean(rewards[-5:]))
    if not coin > .3:
        raise AssertionError(f'MatchCoin did not learn on the card: {rewards}')
    log(f'train MatchCoin: last-5 mean trajectory reward {coin:.3f} after {COIN_CHUNKS} chunks')
    phase_s = time.perf_counter() - t_phase
    log(f'train phase: {phase_s:.1f} s')

    return {'env': 'Explorer', 'n_envs': TRAIN_ENVS, 'res': RES, 'subsample': SUBSAMPLE,
            'width': TRAIN_WIDTH, 'core': 'lstm', 'buffer_size': TRAIN_BUFFER,
            'batch_size': TRAIN_BATCH, 'chunks': TRAIN_CHUNKS, 'env_steps_per_s': rate,
            'ms_per_chunk': 1e3 * seconds / TRAIN_CHUNKS, 'rollout_ms': rollout_ms,
            'learner_ms': learner_ms, 'observe_launches': launches,
            'minibatches': [int(m['minibatches']) for m in history],
            'metrics': history[-1], 'peak_memory_gib': peak, 'build_s': build_s,
            'card_vs_cpu_max_abs_err': errs,
            'transformer': {'n_envs': TF_ENVS, 'batch_size': TF_BATCH, 'chunk_s': tf_s,
                            'rollout_ms': tf_rollout[0], 'learner_ms': tf_learner[0],
                            'metrics': tf_history[-1]},
            'deathmatch': {'agent_envs': DM_TRAIN_ENVS, 'batch_size': DM_TRAIN_BATCH,
                           'chunks': DM_TRAIN_CHUNKS, 'agent_steps_per_s': dm_rate,
                           'rollout_ms': dm_rollout, 'learner_ms': dm_learner,
                           'observe_launches': dm_launches, 'metrics': dm_history[-1]},
            'match_coin_last5': coin, 'phase_s': phase_s, 'card': card}, profile, flagship_env


@contextlib.contextmanager
def timed(owner, name, seconds):
    """Records the seconds of each call of ``owner.name`` in
    ``seconds[name]`` for the block."""
    fn = getattr(owner, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds.setdefault(name, []).append(time.perf_counter() - t0)
    setattr(owner, name, wrapper)
    try:
        yield
    finally:
        setattr(owner, name, fn)


@contextlib.contextmanager
def set_value(owner, name, value):
    """Sets ``owner.name`` to ``value`` for the block."""
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def carry_leaves(x, where=''):
    """(path, leaf) pairs of a training carry: its tensors, and the state
    dicts of the agent and the optimizer."""
    if hasattr(x, 'state_dict'):
        x = x.state_dict()
    if isinstance(x, dict):
        for k, v in x.items():
            yield from carry_leaves(v, f'{where}.{k}')
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from carry_leaves(v, f'{where}[{i}]')
    else:
        yield where, x


class Signalling:
    """An env whose first ``step`` starts a timer that sends this process a
    SIGINT ``after`` seconds later; it counts its steps."""

    def __init__(self, env, after):
        self._env, self._after = env, after
        self.calls, self.timer = 0, None

    def __getattr__(self, name):
        return getattr(self._env, name)

    def step(self, *args):
        self.calls += 1
        if self.timer is None:
            self.timer = threading.Timer(self._after, os.kill, (os.getpid(), signal.SIGINT))
            self.timer.start()
        return self._env.step(*args)


def run_dir_phase(torch, env, tmp, train_line):
    """``train()`` with its run directory at the flagship config (``env``, the
    flagship Explorer env, with a 256-wide LSTM): stats, logs, stored weights
    and full-carry checkpoints; a restore, a continued run, a resume; then a
    profiled MatchCoin run and a SIGINT deferred to a chunk boundary. Returns
    the ``run_dir`` line."""
    import importlib
    from megastep_tpu_torch.models import Agent
    from megastep_tpu_torch.ops import fused
    from megastep_tpu_torch.parallel import checkpoint
    from megastep_tpu_torch.rebar import fsm, numpy as rnumpy, paths, storing
    from megastep_tpu_torch.rebar import logging as rlogging
    train = importlib.import_module('megastep_tpu_torch.demo.train')

    t_phase = time.perf_counter()
    threads = threading.active_count()
    paths.ROOT = str(Path(tmp) / 'traces')
    ckpt = str(Path(tmp) / 'carry')
    kw = dict(width=TRAIN_WIDTH, buffer_size=TRAIN_BUFFER, batch_size=TRAIN_BATCH)
    seconds = {}

    def rows(run_name):
        return {k: np.concatenate(v) for k, v in rnumpy.Reader(run_name, 'stats').read().items()}

    def finite(history, what):
        if not history or not all(train.is_finite(m) for m in history):
            raise AssertionError(f'{what}: no chunk, or a metric that is not finite: {history}')

    # The same chunk outside train(), in this process's state: alone, then
    # beside a running log pump (train()'s only thread) reading the logs every
    # 10 ms, as the JAX module's does, and every POLL_S, as the port's does.
    agent = Agent(env.obs_space, env.action_space, width=TRAIN_WIDTH,
                  generator=torch.Generator().manual_seed(0)).to(DEVICE)
    g = torch.Generator(DEVICE).manual_seed(0)
    bare = [train.init_carry(env, agent, train.optimizer(agent.parameters()), g)]
    step = train.make_train_step(env, TRAIN_BUFFER, TRAIN_BATCH)

    def chunk_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bare[0], _ = step(bare[0], g)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)
    bare_ms = [chunk_ms() for _ in range(2)]
    pump_ms = {}
    for poll_s in (.01, rlogging.POLL_S):
        with set_value(rlogging, 'POLL_S', poll_s), rlogging.via_dir('smoke-pump'):
            pump_ms[poll_s] = chunk_ms()
    del agent, bare, step
    log(f'a chunk outside train(): {", ".join(f"{x:.1f}" for x in bare_ms)} ms alone; '
        + '; '.join(f'{v:.1f} ms beside a log pump reading every {k} s'
                    for k, v in pump_ms.items()))

    with timed(checkpoint, 'save', seconds), timed(checkpoint, 'restore', seconds), \
            timed(torch.profiler.profile, 'export_chrome_trace', seconds):
        # Two chunks with stats, logs, stored weights and a checkpoint at step 2.
        fused.observe.launches = 0
        carry, history = train.train(env, steps=2, run_name='smoke-flagship',
                                     full_checkpoint=ckpt, checkpoint_every=2, **kw)
        torch.cuda.synchronize()
        launches = fused.observe.launches
        if launches != 1 + 2 * TRAIN_BUFFER:
            raise AssertionError(f'run directory: {launches} observe launches, '
                                 f'not {1 + 2 * TRAIN_BUFFER}')
        finite(history, 'run directory')
        stats = rows('smoke-flagship')
        opt = sorted(set(history[0]) - {'samples', 'traj_reward', 'step_reward', 'trajs',
                                        'minibatches'})
        want = (['rate/sample-rate/actor', 'mean/traj-reward/mean', 'mean/step-reward',
                 'cumsum/count/traj', 'duty/duty/step', 'duty/duty/store',
                 'mean/device/memory/0'] + [f'mean/opt/{k}' for k in opt])
        missing = [c for c in want if c not in stats or not len(stats[c])]
        if missing:
            raise AssertionError(f'stats channels without rows: {missing}; have {sorted(stats)}')
        for c, r in stats.items():
            for f in r.dtype.names[1:]:
                if not np.isfinite(r[f]).all():
                    raise AssertionError(f'stats channel {c}, field {f}: {r[f]}')
        text = ''.join(p.read_text() for p in paths.glob('smoke-flagship', 'logs', pattern='*.txt'))
        if 'step 0 done' not in text or 'step 1 done' not in text:
            raise AssertionError(f'the log lacks a chunk: {text[-2000:]}')
        stored = storing.load('smoke-flagship')['agent']
        Agent(env.obs_space, env.action_space, width=TRAIN_WIDTH).load_state_dict(stored)
        if checkpoint.latest_step(ckpt) != 2:
            raise AssertionError(f'latest checkpoint {checkpoint.latest_step(ckpt)}, not 2')
        ckpt_bytes = (Path(ckpt) / '2.pt').stat().st_size
        step_ms = [1e3 * x for x in stats['duty/duty/step']['duration']]
        store_ms = [1e3 * x for x in stats['duty/duty/store']['duration']]
        log(f'run directory: {launches} observe launches; {len(stats)} stats channels; '
            f'chunks {", ".join(f"{a + b:.1f}" for a, b in zip(step_ms, store_ms))} ms '
            f'(store {", ".join(f"{b:.1f}" for b in store_ms)} ms), '
            f'{train_line["ms_per_chunk"]:.1f} ms without; checkpoint {ckpt_bytes} bytes')

        # A restore alone: the carry equals the first run's, tensor for tensor.
        restored, _ = train.train(env, steps=0, run_name='smoke-restore',
                                  full_checkpoint=ckpt, **kw)
        mine, theirs = list(carry_leaves(restored)), list(carry_leaves(carry))
        if [p for p, _ in mine] != [p for p, _ in theirs]:
            raise AssertionError('the restored carry has another structure')
        for (p, a), (_, b) in zip(mine, theirs):
            same = torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
            if not same:
                raise AssertionError(f'restored carry differs at {p}')
        log(f'restore: {len(mine)} leaves equal, optimizer count {restored.opt.count}')
        del restored, carry, mine, theirs

        # A continued run numbers its checkpoints on.
        _, continued = train.train(env, steps=1, run_name='smoke-continue',
                                   full_checkpoint=ckpt, checkpoint_every=1, **kw)
        finite(continued, 'continued run')
        if checkpoint.latest_step(ckpt) != 3:
            raise AssertionError(f'latest checkpoint {checkpoint.latest_step(ckpt)}, not 3')

        # Resume: the stored weights, bit for bit.
        resumed, _ = train.train(env, steps=0, run_name='smoke-resume',
                                 resume='smoke-flagship', **kw)
        state = resumed.agent.state_dict()
        if set(state) != set(stored) or not all(torch.equal(state[k].cpu(), stored[k])
                                                for k in stored):
            raise AssertionError('resumed parameters differ from the stored ones')
        del resumed, state

        # A profiled chunk of MatchCoin.
        coin = dict(width=COIN_WIDTH, buffer_size=COIN_BUFFER,
                    batch_size=COIN_BUFFER * COIN_ENVS, lr=COIN_LR)
        train.train(fsm.MatchCoin(COIN_ENVS, device=DEVICE), steps=2, run_name='smoke-profile',
                    profile=1, **coin)
        traces = list(paths.subdirectory('smoke-profile', 'profile').iterdir())
        if len(traces) != 1 or not traces[0].stat().st_size:
            raise AssertionError(f'profile traces {traces}')
        trace_bytes = traces[0].stat().st_size

    # SIGINT during an open-ended run: raised after a whole chunk.
    signalling = Signalling(fsm.MatchCoin(COIN_ENVS, device=DEVICE), SIGINT_AFTER_S)
    try:
        train.train(signalling, steps=None, run_name='smoke-sigint', **coin)
    except KeyboardInterrupt:
        pass
    else:
        raise AssertionError('the SIGINT did not end the run')
    signalling.timer.join(10)
    chunks, rest = divmod(signalling.calls, COIN_BUFFER)
    sigint = rows('smoke-sigint')
    # Every channel has a row per chunk, but the vitals: those are throttled
    # to one row per 10 s of the process, so a chunk may hold none.
    counts = {c: len(r) for c, r in sigint.items()}
    per_chunk = {n for c, n in counts.items() if not c.startswith('mean/device/')}
    throttled = [n for c, n in counts.items() if c.startswith('mean/device/')]
    if rest or not chunks or per_chunk != {chunks} or any(n > chunks for n in throttled):
        raise AssertionError(f'SIGINT after {signalling.calls} env steps; stats rows {counts}')
    if threading.active_count() != threads:
        raise AssertionError(f'{threading.active_count()} threads alive, {threads} before '
                             f'the phase: {threading.enumerate()}')
    phase_s = time.perf_counter() - t_phase
    log(f'run directory phase: save {seconds["save"]} s, restore {seconds["restore"]} s, '
        f'trace {trace_bytes} bytes written in {seconds["export_chrome_trace"]} s; SIGINT '
        f'after {chunks} whole chunks; {phase_s:.1f} s')
    return {'env': 'Explorer', 'n_envs': env.n_envs, 'width': TRAIN_WIDTH,
            'buffer_size': TRAIN_BUFFER, 'batch_size': TRAIN_BATCH,
            'observe_launches': launches,
            'chunk_ms': [a + b for a, b in zip(step_ms, store_ms)], 'step_ms': step_ms,
            'store_ms': store_ms, 'ms_per_chunk_without': train_line['ms_per_chunk'],
            'bare_chunk_ms': bare_ms,
            'bare_chunk_beside_pump_ms': {str(k): v for k, v in pump_ms.items()},
            'checkpoint_bytes': ckpt_bytes, 'save_s': seconds['save'],
            'restore_s': seconds['restore'], 'trace_bytes': trace_bytes,
            'trace_write_s': seconds['export_chrome_trace'], 'stats_channels': len(stats),
            'sigint_chunks': chunks, 'phase_s': phase_s, 'card': train_line['card']}


def plotting_support():
    """What the port's encoder can draw and encode with here, without importing
    it: ``(found, missing)``, ``missing`` naming what demo() lacks to plot."""
    import importlib.util
    import shutil
    found = {name: importlib.util.find_spec(mod) is not None
             for name, mod in (('matplotlib', 'matplotlib'), ('pillow', 'PIL'), ('pyav', 'av'))}
    found['ffmpeg'] = shutil.which('ffmpeg')
    missing = [] if found['matplotlib'] else ['matplotlib']
    if not (found['pillow'] or found['pyav'] or found['ffmpeg']):
        missing.append('Pillow (or PyAV, or an ffmpeg binary)')
    return found, missing


class DemoEnv:
    """An env for one demo() run that records, for each step, CUDA events
    around ``step``, env ``d``'s observation copied to the host, and the
    agents of step ``DEMO_CHECK_STEP``; and the wall time of ``state``."""

    def __init__(self, torch, env, d):
        self._env, self._torch, self._d = env, torch, d
        self.events, self.obs, self.state_s, self.agents = [], [], 0., None

    def __getattr__(self, name):
        return getattr(self._env, name)

    def event(self):
        e = self._torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def step(self, env_state, decision, g):
        start = self.event()
        env_state, world = self._env.step(env_state, decision, g)
        self.events.append((start, self.event()))
        if len(self.obs) == DEMO_CHECK_STEP:
            self.agents = env_state.agents  # what this step's observe saw
        A, d = self._env.core.n_agents, self._d
        self.obs.append({k: world.obs[k][d * A:(d + 1) * A, 0].cpu().numpy()
                         for k in ('rgb', 'd')})
        return env_state, world

    def state(self, *args):
        t0 = time.perf_counter()
        try:
            return self._env.state(*args)
        finally:
            self.state_s += time.perf_counter() - t0


def demo_run(torch, env, agent, length, d, missing, **kwargs):
    """One ``demo()`` on ``env`` with ``agent``: counts the observe kernel's
    launches in it, times the rollout (CUDA events around each agent forward
    and env step) apart from the snapshots and the encoder (wall clock),
    checks every snapshot against that step's observation, then holds the
    kernel launch of step ``DEMO_CHECK_STEP`` against its plain version on
    the same inputs (no ray may differ) and times both. With ``missing``
    empty the port's encoder plots and encodes in its process pool; else a
    recorder of the snapshots stands in for it. Returns the run's numbers,
    the check's numbers and output, and the kernel's inputs."""
    import importlib
    from megastep_tpu_torch.ops import fused, render
    from megastep_tpu_torch.rebar import recording
    train = importlib.import_module('megastep_tpu_torch.demo.train')

    probe = DemoEnv(torch, env, d)
    A = env.core.n_agents
    tex_width = int(env.core.scenery.tex_width[d])
    real = recording.ParallelEncoder
    seconds = {'encoder': 0.}

    class Encoder:
        """The port's ParallelEncoder (or, with ``missing``, nothing), with
        every snapshot checked and the encoder's wall time kept."""

        def __init__(self, f, fps=20, N=None, backend='process'):
            self.inner = None if missing else real(f, fps, N, backend)
            self.frames = 0

        def _timed(self, fn):
            t0 = time.perf_counter()
            if self.inner is not None:
                fn()
            seconds['encoder'] += time.perf_counter() - t0

        def __enter__(self):
            self._timed(lambda: self.inner.__enter__())
            return self

        def __exit__(self, *exc):
            self._timed(lambda: self.inner.__exit__(*exc))
            return False

        def __call__(self, snap):
            check_snapshot(snap, probe.obs[-1], A, tex_width)
            self.frames += 1
            self._timed(lambda: self.inner(snap))

    forward = []
    hooks = [agent.register_forward_pre_hook(lambda m, a: forward.append([probe.event()])),
             agent.register_forward_hook(lambda m, a, o: forward[-1].append(probe.event()))]
    try:
        with set_value(recording, 'ParallelEncoder', Encoder):
            fused.observe.launches = 0
            t0 = time.perf_counter()
            encoder = train.demo(env=probe, agent=agent, length=length, d=d, **kwargs)
            torch.cuda.synchronize()
            demo_s = time.perf_counter() - t0
            launches = fused.observe.launches
    finally:
        for h in hooks:
            h.remove()
    if launches != 1 + length or encoder.frames != length:
        raise AssertionError(f'demo: {launches} observe launches and {encoder.frames} '
                             f'frames, not {1 + length} and {length}')
    if next(agent.parameters()).device.type != env.device.type:
        raise AssertionError("the agent is not on the env's device")
    agent_ms = [a.elapsed_time(b) for a, b in forward]
    step_ms = [a.elapsed_time(b) for a, b in probe.events]
    nums = {'frames': length, 'observe_launches': launches, 'demo_s': demo_s,
            'rollout_ms_per_step': (sum(agent_ms) + sum(step_ms)) / length,
            'agent_ms_per_step': sum(agent_ms) / length,
            'env_ms_per_step': sum(step_ms) / length,
            'snapshot_s_per_frame': probe.state_s / length,
            'encoder_s_per_frame': seconds['encoder'] / length,
            'bytes': None, 'mimetype': None, 'frames_decoded': None}
    if not missing:
        video = encoder.inner.result()
        nums.update(bytes=len(video), mimetype=encoder.inner.mimetype)
        if encoder.inner.mimetype == 'gif':
            from io import BytesIO
            from PIL import Image
            nums['frames_decoded'] = Image.open(BytesIO(video)).n_frames
            if nums['frames_decoded'] != length:
                raise AssertionError(f'the GIF holds {nums["frames_decoded"]} frames')
        if not video:
            raise AssertionError('the encoder wrote no bytes')

    args, kw = env.observe_args(probe.agents)
    out, check = check_observe(torch, fused, render, args, kw)
    if check['differing']:
        raise AssertionError(f'demo step {DEMO_CHECK_STEP}: {check["differing"]} rays '
                             'differ from the plain version')
    return nums, check, out, (args, kw)


def check_snapshot(snap, obs, n_agents, tex_width):
    """A demo snapshot: numpy leaves (and Python numbers) only, the step's
    observation of its env on the host, and a finite value per bar. Explorer's
    seen mask spans the env's texels; Deathmatch's value bar input, env
    ``d``'s one value as in the JAX demo(), broadcasts over its agents."""
    for where, x in carry_leaves(snap, 'state'):
        if not isinstance(x, (np.ndarray, np.generic, int, float)):
            raise AssertionError(f'{where} is a {type(x).__name__}, not host data')
    for k in ('rgb', 'd'):
        if not np.array_equal(snap[k], obs[k]):
            raise AssertionError(f'snapshot {k} differs from the step\'s observation')
    value = snap.decision.value
    if value.shape != (1,) or not np.isfinite(value).all():
        raise AssertionError(f'decision.value {value}')
    if 'seen' in snap and snap.seen.shape != (tex_width,):
        raise AssertionError(f'seen {snap.seen.shape}, not ({tex_width},)')
    if 'health' in snap and (len(snap.health) != n_agents
                             or np.broadcast_shapes(value.shape, (n_agents,)) != (n_agents,)):
        raise AssertionError(f'{len(snap.health)} health bars, value {value.shape}')


def demo_phase(torch, flagship_env, geoms):
    """``demo()`` on the card: the flagship Explorer env with the agent that
    ``run_dir_phase`` stored ('smoke-flagship', 256 wide), DEMO_LENGTH frames
    of env DEMO_D; then Deathmatch at DM_DEMO_ENVS agent-envs with a fresh
    256-wide agent, DM_DEMO_LENGTH frames. Each is plotted and encoded in the
    port's process pool where this machine has matplotlib and an encoder
    backend. Returns the ``demo`` line and the two kernel entries."""
    from megastep_tpu_torch.models import Agent
    from megastep_tpu_torch.ops import fused
    from megastep_tpu_torch.perf import roofline

    t_phase = time.perf_counter()
    found, missing = plotting_support()
    log(f'demo: matplotlib {found["matplotlib"]}, Pillow {found["pillow"]}, PyAV '
        f'{found["pyav"]}, ffmpeg {found["ffmpeg"]}; plotted: {not missing}'
        + (f' (missing {", ".join(missing)})' if missing else ''))
    workers = max(len(os.sched_getaffinity(0)) // 2, 1)
    line = {'plotted': not missing, 'missing': missing, 'found': found, 'workers': workers}
    entries = []
    # Explorer loads the stored weights (demo()'s default); Deathmatch's
    # agent keeps its fresh ones.
    runs = (('explorer', lambda: flagship_env, DEMO_LENGTH, DEMO_D, 'explorer', True),
            ('deathmatch', lambda: deathmatch_env(geoms, DM_DEMO_ENVS, 2), DM_DEMO_LENGTH,
             DM_DEMO_D, 'patch', False))
    for name, make_env, length, d, mode, stored in runs:
        env = make_env()
        agent = Agent(env.obs_space, env.action_space, width=TRAIN_WIDTH,
                      generator=torch.Generator().manual_seed(5))
        kwargs = dict(run='smoke-flagship') if stored else dict(params=agent.state_dict())
        nums, check, out, (args, kw) = demo_run(torch, env, agent, length, d, missing,
                                                N=workers, **kwargs)
        scn = env.core.scenery
        ms, plain_ms = time_observe(torch, fused, args, kw)
        if mode == 'explorer':
            bound_ms, bound_by, work = roofline.bound(scn, out, scn.n_dynamic)
        else:
            bound_ms, bound_by, work = roofline.bound(scn, out, 0, scn.n_dynamic_texels)
        log(f'demo {name}: {env.n_envs} envs, {nums}; check of step {DEMO_CHECK_STEP}: '
            f'{check}; observe ({mode}) {ms:.4f} ms/launch, plain {plain_ms:.3f} ms, '
            f'bound {bound_ms:.4f} ms ({bound_by}; {work})')
        line[name] = dict(nums, n_envs=env.n_envs, d=d, check=check)
        entry = kernel_entry(mode, nums['observe_launches'], check['max_abs_err'], ms,
                             plain_ms, bound_ms, bound_by)
        entry['name'] = f'observe ({mode}, demo)'
        entries.append(entry)
        del env, agent, out, args, kw
    line['phase_s'] = time.perf_counter() - t_phase
    log(f'demo phase: {line["phase_s"]:.1f} s')
    return line, entries


def sharded_chunks(torch, m, step, carry, g, n, digest):
    """``n`` chunks of a sharded ``step``, each timed on the host clock (ended
    by a sync); each chunk's metrics, collectives by kind, parameter digest and
    seconds. Returns the carry and the chunks."""
    chunks = []
    for _ in range(n):
        m.counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, metrics = step(carry, g)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        chunks.append(dict(metrics=metrics, counts=dict(m.counts), digest=digest(),
                           seconds=seconds))
    return carry, chunks


def check_chunks(chunks, what):
    """Every chunk's metrics finite, a minibatch run, and the collectives the
    sharded step's design needs, and no other."""
    from megastep_tpu_torch.parallel.mesh import chunk_collectives
    for c in chunks:
        m = c['metrics']
        if not all(math.isfinite(v) for v in m.values()) or m['minibatches'] < 1:
            raise AssertionError(f'{what}: a chunk ran no minibatch or has a metric that '
                                 f'is not finite: {m}')
        want = dict(chunk_collectives(int(m['minibatches'])))
        if c['counts'] != want:
            raise AssertionError(f'{what}: collectives {c["counts"]}, not {want}')


def rank_entry(torch, m, env, carry, mode, launches, barrier):
    """One observe launch of this rank's env at its carry's poses against its
    plain version, then its times, taken by one rank at a time (``barrier``
    between them), and its bound. Returns the check and the kernel entry's
    numbers."""
    from megastep_tpu_torch.ops import fused, render
    from megastep_tpu_torch.perf import roofline
    scn = env.core.scenery
    if mode == 'explorer':
        args, kw = env.observe_args(carry.env_state.agents)
        out, check = check_observe(torch, fused, render, args, kw)
        bound_ms, bound_by, _ = roofline.bound(scn, out, scn.n_dynamic)
    else:
        modes, drawn = deathmatch_modes(env, carry.env_state.agents)
        args, kw = modes[mode]
        out, check = check_observe(torch, fused, render, args, kw, drawn)
        bound_ms, bound_by, _ = roofline.bound(scn, out, 0, scn.n_dynamic_texels)
    if check['differing']:
        raise AssertionError(f'rank {m.rank}: {check["differing"]} rays of {mode} differ '
                             'from the plain version')
    for r in range(m.world):
        if r == m.rank:
            ms, plain_ms = time_observe(torch, fused, args, kw)
        barrier()
    return dict(launches=launches, check=check, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


@contextlib.contextmanager
def deterministic_cudnn(torch):
    """cuDNN restricted to its deterministic algorithms for the block: its
    default weight-gradient algorithm sums with atomics, so two runs of one
    chunk from the same start differ in the last bits, and AMSGrad's
    normalised steps carry such a difference up to the learning rate."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def parallel_rank(rank, cfg, init_method, out_dir):
    """One gloo rank of the parallel phase's world 2 on the one card: the
    flagship config's sharded step on this rank's ``cfg['envs'] / 2`` envs,
    then a scene-sharded Deathmatch; each with its observe launch against the
    plain version. Writes its results to ``out_dir/rank<r>.json``."""
    import importlib
    import torch
    import torch.distributed as dist
    from megastep_tpu_torch import floorplans
    from megastep_tpu_torch.models import Agent
    from megastep_tpu_torch.ops import fused
    from megastep_tpu_torch.parallel import host
    from megastep_tpu_torch.rebar import processes
    pmesh = importlib.import_module('megastep_tpu_torch.parallel.mesh')
    train = importlib.import_module('megastep_tpu_torch.demo.train')

    device, world = cfg['device'], cfg['world']
    geoms = floorplans.sample(N_GEOMETRIES)
    out = {}
    with processes.processgroup('gloo', init_method, world, rank):
        m = pmesh.mesh(device)
        runs = (('explorer', lambda: host.sharded_explorer(
                    cfg['envs'], m, tiled(geoms, cfg['envs']), res=cfg['res'],
                    subsample=cfg['subsample']), cfg['buffer'], cfg['batch'], 1 + cfg['chunks']),
                ('patch', lambda: host.sharded_deathmatch(
                    cfg['dm_envs'], m, tiled(geoms, cfg['dm_envs'] // DM_AGENTS),
                    n_agents=DM_AGENTS, res=cfg['dm_res'], subsample=cfg['subsample']),
                 cfg['dm_buffer'], cfg['dm_batch'], 1))
        for mode, make_env, buffer, batch, n in runs:
            t0 = time.perf_counter()
            env = make_env()
            agent = Agent(env.obs_space, env.action_space, width=cfg['width'],
                          generator=torch.Generator().manual_seed(0)).to(device)
            g = torch.Generator(device).manual_seed(rank)
            fused.observe.launches = 0
            carry, step = pmesh.init_sharded(env, agent, train.optimizer(agent.parameters()),
                                             g, m, buffer_size=buffer, batch_size=batch)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            carry, chunks = sharded_chunks(torch, m, step, carry, g, n,
                                           lambda: pmesh.digest(agent.parameters()))
            out[mode] = dict(rank_entry(torch, m, env, carry, mode, fused.observe.launches,
                                        dist.barrier),
                             n_envs=env.n_envs, build_s=build_s, chunks=chunks)
            del env, agent, carry, step
    (Path(out_dir) / f'rank{rank}.json').write_text(json.dumps(out))


def parallel_phase(torch, flagship_env, tmp):
    """The multi-device layer on the one card. World 1: the flagship env's
    sharded train step over a one-rank NCCL group (a warm-up chunk and
    PAR_CHUNKS timed ones), its first chunk held against the single-device
    step from the same start (both with cuDNN's deterministic algorithms; the
    single-device chunk is run once more without them, to show what they
    remove), and one K1a launch against plain. World 2: two
    gloo ranks spawned on the same card, each the flagship config on half the
    envs, then a scene-sharded Deathmatch; their parameters after every chunk
    and their metrics bit-equal, and each rank's K1a and K1b launch against
    plain. Returns the ``parallel`` line and the kernel entries."""
    import copy
    import importlib
    from megastep_tpu_torch.arrdict import arrdict
    from megastep_tpu_torch.models import Agent
    from megastep_tpu_torch.ops import fused
    from megastep_tpu_torch.rebar import processes
    pmesh = importlib.import_module('megastep_tpu_torch.parallel.mesh')
    train = importlib.import_module('megastep_tpu_torch.demo.train')

    t_phase = time.perf_counter()
    env = flagship_env
    kw = dict(buffer_size=TRAIN_BUFFER, batch_size=TRAIN_BATCH)
    agent = Agent(env.obs_space, env.action_space, width=TRAIN_WIDTH,
                  generator=torch.Generator().manual_seed(0)).to(DEVICE)
    opt = train.optimizer(agent.parameters())
    g = torch.Generator(DEVICE).manual_seed(0)
    digest = lambda: pmesh.digest(agent.parameters())  # noqa: E731
    with processes.processgroup(WORLD1_BACKEND, f'file://{tmp}/world1', 1, 0):
        m = pmesh.mesh(DEVICE)
        fused.observe.launches = 0
        # The single-device step draws its permutation from the rollout's
        # generator: so does the sharded one here, to take the same minibatches.
        carry, step = pmesh.init_sharded(env, agent, opt, g, m, perm_generator=g, **kw)
        start = dict(agent=copy.deepcopy(agent),
                     opt={k: [t.clone() for t in v] if isinstance(v, list) else v
                          for k, v in opt.state_dict().items()},
                     carry=arrdict({k: carry[k].map(torch.clone)
                                    for k in ('env_state', 'world', 'agent_state')}),
                     g=g.get_state())
        with deterministic_cudnn(torch):
            carry, chunks = sharded_chunks(torch, m, step, carry, g, 1, digest)
        first = [p.detach().clone() for p in agent.parameters()]
        carry, timed_chunks = sharded_chunks(torch, m, step, carry, g, PAR_CHUNKS, digest)
        chunks += timed_chunks
        launches = fused.observe.launches
    check_chunks(chunks, 'world 1')
    if launches != 1 + TRAIN_BUFFER * (1 + PAR_CHUNKS):
        raise AssertionError(f'world 1: {launches} observe launches')
    rate1 = TRAIN_ENVS * TRAIN_BUFFER * PAR_CHUNKS / sum(c['seconds'] for c in timed_chunks)

    def single_device():
        """One chunk of the single-device step from the sharded run's start:
        the parameters after it, its metrics, and its seconds (host clock,
        ended by a sync)."""
        agent0 = copy.deepcopy(start['agent'])
        opt0 = train.optimizer(agent0.parameters())
        opt0.load_state_dict(start['opt'])
        g0 = torch.Generator(DEVICE)
        g0.set_state(start['g'])
        carry0 = arrdict(agent=agent0, opt=opt0,
                         **{k: v.map(torch.clone) for k, v in start['carry'].items()})
        step0 = train.make_train_step(env, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step0(carry0, g0)
        torch.cuda.synchronize()
        return [p.detach() for p in agent0.parameters()], metrics, time.perf_counter() - t0

    def max_diff(ps, qs):
        return max(float((p - q).abs().max()) for p, q in zip(ps, qs))

    with deterministic_cudnn(torch):
        params0, plain, _ = single_device()
    world1_err = max_diff(params0, first)
    if not all(torch.allclose(p, q, **TOL) for p, q in zip(params0, first)):
        raise AssertionError(f'world 1 differs from the single-device step by up to '
                             f'{world1_err} in the parameters after one chunk')
    metrics_err = max(abs(plain[k] - chunks[0]['metrics'][k]) for k in plain)
    # Again without deterministic cuDNN: what it removes, and a single-device
    # chunk timed in this process beside the sharded ones.
    params1, _, single_s = single_device()
    nondeterministic_err = max_diff(params1, params0)
    w1 = rank_entry(torch, m, env, carry, 'explorer', launches, lambda: None)
    log(f'parallel world 1 ({WORLD1_BACKEND}): {TRAIN_ENVS} envs, {rate1:.0f} env-steps/s over '
        f'{PAR_CHUNKS} chunks after a warm-up one (a single-device chunk in this process: '
        f'{1e3 * single_s:.1f} ms); collectives a chunk {chunks[-1]["counts"]}; '
        f'against the single-device step after one chunk: parameters within {world1_err} '
        f'(rtol {TOL["rtol"]}, atol {TOL["atol"]}), metrics within {metrics_err}; the '
        f'single-device chunk again without deterministic cuDNN: parameters within '
        f'{nondeterministic_err}; observe launches {launches}, check {w1["check"]}')
    del agent, opt, carry, step, start, first, params0, params1

    # World 2: gloo, because NCCL refuses two ranks on one GPU.
    cfg = dict(device=DEVICE, world=PAR_WORLD, envs=TRAIN_ENVS, res=RES, subsample=SUBSAMPLE,
               width=TRAIN_WIDTH, buffer=TRAIN_BUFFER, batch=TRAIN_BATCH, chunks=PAR_CHUNKS,
               dm_envs=PAR_DM_ENVS, dm_res=DM_RES, dm_buffer=PAR_DM_BUFFER,
               dm_batch=PAR_DM_BATCH)
    out_dir = Path(tmp) / 'parallel'
    out_dir.mkdir()
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(parallel_rank, args=(cfg, f'file://{tmp}/world2', str(out_dir)),
                                nprocs=PAR_WORLD)
    spawn_s = time.perf_counter() - t0
    log(f'parallel world 2: {PAR_WORLD} gloo ranks on one card, gloo all_reduce and broadcast '
        f'on {DEVICE} tensors (torch {torch.__version__}), {spawn_s:.1f} s')
    ranks = [json.loads((out_dir / f'rank{r}.json').read_text()) for r in range(PAR_WORLD)]
    entries = [kernel_entry('explorer', launches, w1['check']['max_abs_err'], w1['ms'],
                            w1['plain_ms'], w1['bound_ms'], w1['bound_by'])]
    entries[0]['name'] = f'observe (explorer, parallel world 1, {WORLD1_BACKEND})'
    line = {'world1': {'backend': WORLD1_BACKEND, 'n_envs': TRAIN_ENVS, 'chunks': PAR_CHUNKS,
                       'env_steps_per_s': rate1,
                       'chunk_s': [c['seconds'] for c in chunks],
                       'single_device_chunk_s': single_s,
                       'collectives': chunks[-1]['counts'], 'observe_launches': launches,
                       'vs_single_device_params_max_abs': world1_err,
                       'vs_single_device_metrics_max_abs': metrics_err,
                       'single_device_rerun_nondeterministic_params_max_abs':
                           nondeterministic_err,
                       'metrics': chunks[-1]['metrics']},
            'world2': {'backend': 'gloo', 'ranks': PAR_WORLD, 'one_card': True,
                       'tensors_on': DEVICE, 'torch': torch.__version__,
                       'spawn_s': spawn_s}}
    for mode, what, n_total, unit, buffer in (
            ('explorer', 'explorer', TRAIN_ENVS, 'env', TRAIN_BUFFER),
            ('patch', 'deathmatch', PAR_DM_ENVS, 'agent', PAR_DM_BUFFER)):
        runs = [r[mode] for r in ranks]
        for r, run in enumerate(runs):
            check_chunks(run['chunks'], f'world 2 {what}, rank {r}')
            if run['n_envs'] != n_total // PAR_WORLD:
                raise AssertionError(f'world 2 {what}: rank {r} holds {run["n_envs"]} envs')
        for i, cs in enumerate(zip(*(run['chunks'] for run in runs))):
            if len({c['digest'] for c in cs}) != 1 or len({json.dumps(c['metrics'])
                                                            for c in cs}) != 1:
                raise AssertionError(f'world 2 {what}: the ranks differ after chunk {i}')
        # Explorer's first chunk is its warm-up; Deathmatch's one chunk is
        # timed with its warm-up.
        timed = [run['chunks'][1:] or run['chunks'] for run in runs]
        rate = n_total * buffer * len(timed[0]) / max(sum(c['seconds'] for c in t)
                                                     for t in timed)
        last = timed[0][-1]
        line['world2'][what] = {
            'n_envs': n_total, f'{unit}_steps_per_s': rate,
            'build_s': [run['build_s'] for run in runs],
            'chunk_s': [[c['seconds'] for c in run['chunks']] for run in runs],
            'collectives': last['counts'], 'digests_equal': True,
            'observe_launches': [run['launches'] for run in runs],
            'metrics': last['metrics']}
        log(f'parallel world 2 (gloo, {PAR_WORLD} ranks on one card) {what}: {n_total} '
            f'{"agent-" if unit == "agent" else ""}envs, {rate:.0f} {unit}-steps/s (one card '
            f'shared, not a scaling figure); '
            f'parameters and metrics bit-equal across the ranks after every chunk; '
            f'collectives a chunk {last["counts"]}; observe launches '
            f'{[run["launches"] for run in runs]}; checks {[run["check"] for run in runs]}')
        for r, run in enumerate(runs):
            entry = kernel_entry(mode, run['launches'], run['check']['max_abs_err'], run['ms'],
                                 run['plain_ms'], run['bound_ms'], run['bound_by'])
            entry['name'] = f'observe ({mode}, parallel world 2, gloo, rank {r})'
            entries.append(entry)
    line['phase_s'] = time.perf_counter() - t_phase
    log(f'parallel phase: {line["phase_s"]:.1f} s')
    return line, entries


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
    # The cubicasa pipeline's cache directory, read when the port is imported:
    # the real-plans phase writes its dataset zip and geometry cache there.
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as cache:
        os.environ['MEGASTEP_TPU_CACHE'] = cache
        return smoke(torch, opts, cache)


def smoke(torch, opts, tmp):
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

    # 6. Minimal, through the un-fused render; then Explorer and Deathmatch on
    # real plans, the cubicasa fixtures converted by the port's pipeline.
    torch.cuda.reset_peak_memory_stats()
    minimal, minimal_profile = minimal_phase(torch, opts)
    plans, convert_s = real_plans(torch)
    real_explorer, real_explorer_kernel, _, _ = explorer_phase(
        torch, argparse.Namespace(profile=False), plans, peaks, REAL)
    real_explorer['convert_s'] = convert_s
    real_deathmatch, real_deathmatch_kernel = deathmatch_real(torch, plans)
    log(f'peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')

    # 7. Training at the flagship config, and the other train checks.
    train_line, train_profile, flagship_env = train_phase(torch, opts, geoms, card)

    # 8. train() with its run directory, on the flagship env.
    run_dir_line = run_dir_phase(torch, flagship_env, tmp, train_line)

    # 9. demo(): the stored flagship agent recorded on its env, then Deathmatch.
    demo_line, demo_kernels = demo_phase(torch, flagship_env, geoms)

    # 10. The multi-device layer: the sharded train step at world 1 (NCCL) and
    # world 2 (gloo, one card).
    parallel_line, parallel_kernels = parallel_phase(torch, flagship_env, tmp)
    del flagship_env

    # After every throughput reading, so that the profiler's tracing cannot
    # touch a timed step.
    if opts.profile:
        explorer_profile()
        deathmatch_profile()
        minimal_profile()
        train_profile()

    for line in (explorer, deathmatch, minimal, real_explorer, real_deathmatch):
        log(json.dumps({'main_path': line}))
    log(json.dumps({'train': train_line}))
    log(json.dumps({'roofline': roofline_line}))
    log(json.dumps({'run_dir': run_dir_line}))
    log(json.dumps({'demo': demo_line}))
    log(json.dumps({'parallel': parallel_line}))
    log(json.dumps({'kernels': [explorer_kernel, *deathmatch_kernels, vpu_kernel,
                                real_explorer_kernel, real_deathmatch_kernel,
                                *demo_kernels, *parallel_kernels]}))
    log(nvidia_smi())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
