"""Roofline accounting for the observe kernel, and peak probes for the card.

Counterpart of the JAX package's ``perf/roofline.py``, for the port's kernels on
an NVIDIA H100:

(a) COUNTS one observe launch's work from its inputs (:func:`observe_counts`)
    as the plain version does it: one ray-line test per (agent, ray, live line
    slot), each a fixed number of f32 operations with its two divides counted
    apart, and the bytes each input and output must move once. The kernel
    (``csrc/observe.cu``) divides only in the few tests a cheap compare cannot
    decide, so it does less than these counts; they stay the plain version's
    so that the rows of every PR compare;
(b) divides by the card's PUBLISHED peaks into per-unit times
    (:func:`analytic`): the f32 pipes with each divide weighted by
    ``div_cost`` instructions, and device memory. The port's kernels use no
    tensor cores, so that unit's time is 0. Units run concurrently, so the
    floor is their max, with the sum as a no-overlap bound;
(c) with ``--measure``, runs three probes on the card: :func:`measure_vpu`
    (the JAX package's Pallas probe K2, here the CUDA kernel
    ``csrc/vpu_probe.cu``), :func:`measure_hbm` and :func:`measure_mxu`. Read
    their rates as LOWER bounds on what the card attains, and the published
    peaks as upper bounds. The published f32 rate counts a fused multiply-add
    as two operations; the kernels are built with ``-fmad=false`` and issue
    none, so a plain f32 stream reaches at most half of it.

:func:`bound` is the smoke run's per-launch bound, the yardstick of the kernel
table: every divide counted as one operation, at the published peaks, the
larger of the bytes' and the operations' times. :func:`vpu_bound` is K2's: its
multiplies at one f32 instruction per lane per clock.

Usage::

    python -m megastep_tpu_torch.perf.roofline            # analytic tables, on the card
    python -m megastep_tpu_torch.perf.roofline --measure  # also the three probes
    python -m megastep_tpu_torch.perf.roofline --device cpu --envs 8  # counts only
"""
import argparse
import ctypes
import subprocess

import numpy as np
import torch

from .. import envs, floorplans, kernels, scene
from ..ops import fused

#: Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12       # outside the tensor cores; an FMA counts 2
#: f32 instructions per second: one per lane per clock, half the FMA-counting
#: rate, which is all a chain of plain multiplies can issue.
F32_INSTRUCTIONS_PER_S = F32_OPS_PER_S / 2
BF16_TC_FLOPS = 989e12      # dense tensor cores
#: f32 operations per ray-line test of the plain version: 2 subtractions for
#: the offset, 3 cross products of 2 multiplies and a subtraction, the absolute
#: value, 2 divides and 4 compares; fast_div has 1 divide and 2 multiplies in
#: place of the 2 divides.
OPS_PER_TEST = 18
OPS_PER_TEST_FAST_DIV = 19
#: Instructions an f32 IEEE divide issues, against one for a multiply: its
#: fast path in the SASS of csrc/observe.cu built for sm_90a is BSSY,
#: MUFU.RCP, FCHK, five FFMA, a branch past the slow path and BSYNC
#: (``chip_smoke.py`` prints it). The JAX package's default was 8.
#: :func:`analytic` weighs every divide of :func:`observe_counts` by it: a
#: floor of the two-divide design, which the kernel may go below.
DIV_COST = 10
#: K2's two multipliers, the JAX probe's np.float32 constants.
UP, DOWN = np.float32(1.0000001), np.float32(0.9999999)


def nvidia_smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    if out.returncode:
        raise RuntimeError(f'nvidia-smi failed: {out.stderr.strip()}')
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# K2: the f32 multiply probe.
# ---------------------------------------------------------------------------

def _check_chain(chain):
    if chain < 2 or chain % 2:
        raise ValueError(f'chain={chain}: two chains need an even length >= 2')


def vpu_chain_plain(x, chain=256):
    """:func:`vpu_chain` as torch ops: ``a = x * UP``, ``b = x * DOWN``, then
    ``chain // 2 - 1`` further multiplies of each, then ``a + b``, all in f32
    (the JAX probe's body, ``perf/roofline.py:86-95``)."""
    _check_chain(chain)
    up = torch.tensor(UP, device=x.device)
    down = torch.tensor(DOWN, device=x.device)
    a, b = x * up, x * down
    for _ in range(chain // 2 - 1):
        a.mul_(up)
        b.mul_(down)
    return a + b


def _lib():
    fn = kernels.load('vpu_probe').vpu_chain
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_longlong, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def vpu_chain(x, chain=256):
    """Two interleaved dependent chains of ``chain / 2`` f32 multiplies per
    element of ``x``, summed: the probe of the card's f32 multiply rate.

    On a CUDA tensor this launches ``csrc/vpu_probe.cu`` on the current stream,
    without synchronising, and adds one to ``vpu_chain.launches``. On a CPU
    tensor it runs :func:`vpu_chain_plain`. There is no fallback from one to
    the other.

    :param x: f32 tensor, contiguous. :param chain: even, at least 2.
    :return: a new tensor of ``x``'s shape.
    """
    _check_chain(chain)
    if x.device.type == 'cpu':
        return vpu_chain_plain(x, chain)
    if x.device.type != 'cuda':
        raise ValueError(f'vpu_chain runs on cuda or cpu, not {x.device}')
    if x.dtype != torch.float32:
        raise TypeError(f'x is {x.dtype}, expected torch.float32')
    if not x.is_contiguous():
        raise ValueError('x must be contiguous')
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        err = _lib()(x.data_ptr(), out.data_ptr(), x.numel(), chain,
                     torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f'vpu_chain kernel launch failed: CUDA error {err}')
    vpu_chain.launches += 1
    return out


#: Kernel launches so far; a caller resets it to 0 before a run it counts.
vpu_chain.launches = 0


# ---------------------------------------------------------------------------
# Peak probes, timed on the card.
# ---------------------------------------------------------------------------

def _timed(step, x, steps, reps=4):
    """Median seconds per launch of ``step``: rep ``i`` of ``reps`` scales ``x``
    by ``1 + 1e-6 * (i + 1)`` (the JAX probe's per-rep perturbation), then
    times ``steps`` chained launches ``y = step(y)`` with CUDA events. One
    untimed run of the chain warms up first."""
    y = x
    for _ in range(steps):
        y = step(y)
    torch.cuda.synchronize()
    times = []
    for rep in range(reps):
        y = x * (1. + 1e-6 * (rep + 1))
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(steps):
            y = step(y)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / steps)
    torch.cuda.synchronize()
    return float(np.median(times))


def _generator(seed):
    device = scene.resolve_device('cuda')
    return device, torch.Generator(device=device).manual_seed(seed)


def measure_vpu(L=256, R=512, chain=256, E=8, n=64, steps=16):
    """Attainable f32 multiply rate: K2 over an (n, E, L, R) f32 input, the JAX
    probe's defaults. Each launch multiplies every element ``chain`` times and
    about doubles it (``a + b``), so 16 chained launches take a normal input
    to some 4e5 at most, far from overflow.

    :return: multiplies per second."""
    device, g = _generator(0)
    x = torch.randn((n, E, L, R), generator=g, device=device)
    dt = _timed(lambda y: vpu_chain(y, chain), x, steps)
    return chain * n * E * L * R / dt


def measure_hbm(mb=512, steps=16):
    """Attainable device-memory stream rate: an elementwise scale of an
    ``mb``-MiB f32 array, far past the 50 MB L2, read and written once a step.

    :return: bytes per second."""
    device, _ = _generator(0)
    n = mb * 1024 * 1024 // 4
    x = torch.ones((4096, n // 4096), device=device)
    dt = _timed(lambda y: y * 1.000001, x, steps)
    return 2 * x.numel() * 4 / dt


def measure_mxu(dim=4096, steps=32):
    """Attainable bf16 tensor-core rate: a dependent chain of ``dim``-square
    bf16 products. ``b`` is scaled by ``dim ** -.5`` so the chain stays
    finite.

    :return: flops per second."""
    device, g = _generator(1)
    a = torch.randn((dim, dim), generator=g, device=device).bfloat16()
    b = (torch.randn((dim, dim), generator=g, device=device) * dim ** -.5).bfloat16()
    dt = _timed(lambda y: torch.matmul(y, b), a, steps)
    return 2 * dim**3 / dt


# ---------------------------------------------------------------------------
# Counts of the observe kernel's work, and bounds.
# ---------------------------------------------------------------------------

def roofline_ms(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    """The larger of ``nbytes`` over the published memory rate and ``ops`` f32
    operations over ``ops_per_s`` (the published f32 rate unless given), in
    ms, and which one it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def vpu_bound(numel, chain):
    """K2's bound: ``chain`` multiplies and one add per element, each element
    read once and written once. A chain of multiplies has no add to fuse, so
    each is one instruction at :data:`F32_INSTRUCTIONS_PER_S`; at the probe's
    (64, 8, 256, 512) input and chain 256 that is about 0.515 ms.
    :return: ``(ms, 'bytes' or 'operations')``."""
    return roofline_ms(8 * numel, (chain + 1) * numel, F32_INSTRUCTIONS_PER_S)


def observe_counts(scenery, out, skip=0, t_dyn=0, fast_div=False):
    """Work of one observe on these inputs, as the plain version does it per
    test: only live line slots (below each env's ``lines_width``) are tested,
    and every test counts two divides (one with ``fast_div``). The kernel
    divides in far fewer tests; see the module's note (a).

    :param scenery: the launch's scenery (its ``lines_width``).
    :param out: the launch's output (``indices``, and ``seen`` if asked for).
    :param skip: ``skip_dyn``. :param t_dyn: ``baked_dyn``'s texels per env.
    :return: dict of ``live`` line slots, ``ray_line_tests``, f32 ``ops`` other
        than divides, ``divides``, ``hits`` (rays that hit a line) and
        ``bytes``, each input read once and each output written once.
    """
    N, A, R = out.indices.shape
    live = int((scenery.lines_width - skip).clamp(min=0).sum())
    hits = int((out.indices >= 0).sum())
    nbytes = (live * 24            # live line slots: endpoints, texel start, width
              + N * A * 12         # pose: angle, x, y
              + N * t_dyn * 4      # this frame's model-texel intensities
              + hits * 32          # two 16-byte texel taps per hit ray
              + N * A * R * 20)    # index, distance, rgb per ray
    if 'seen' in out:
        nbytes += out.seen.numel() + hits  # seen mask zero-fill, one byte per hit
    tests = A * R * live
    per_test, divides = (OPS_PER_TEST_FAST_DIV, 1) if fast_div else (OPS_PER_TEST, 2)
    return dict(live=live, ray_line_tests=tests, ops=tests * (per_test - divides),
                divides=tests * divides, hits=hits, bytes=nbytes)


def bound(scenery, out, skip=0, t_dyn=0, fast_div=False):
    """Least time the card could take for one observe on these inputs: bytes
    over the memory rate or operations over the f32 rate, whichever is larger,
    at the published peaks, each divide counted as one operation.

    :return: ``(ms, 'bytes' or 'operations', counts)``, with
        :func:`observe_counts`' counts."""
    counts = observe_counts(scenery, out, skip, t_dyn, fast_div)
    ms, by = roofline_ms(counts['bytes'], counts['ops'] + counts['divides'])
    return ms, by, counts


def env_shapes(kind, n_envs, device='cuda'):
    """Builds the bench env, as ``chip_smoke.py`` does: Explorer at ``n_envs``
    envs, or Deathmatch at ``n_envs`` agent-envs (scenes of 4 agents), on up to
    512 procedural floorplans tiled over the scenes."""
    n_scenes = max(n_envs // 4, 1) if kind == 'deathmatch' else n_envs
    geoms = floorplans.sample(min(n_scenes, 512))
    geoms = [geoms[i % len(geoms)] for i in range(n_scenes)]
    random = np.random.RandomState(0)
    if kind == 'deathmatch':
        return envs.Deathmatch(n_envs, n_agents=4, geometries=geoms, random=random,
                               device=device)
    return envs.Explorer(n_envs, geometries=geoms, random=random, device=device)


def published_peaks():
    return dict(f32_ops=F32_OPS_PER_S, hbm_bytes=HBM_BYTES_PER_S,
                tc_flops=BF16_TC_FLOPS, div_cost=DIV_COST)


def _unit_times(counts, rates, div_cost):
    f32 = (counts['ops'] + counts['divides'] * div_cost) / rates['f32_ops']
    hbm = counts['bytes'] / rates['hbm_bytes']
    tc = 0.  # the port's kernels use no tensor cores
    floor, binding = max((f32, 'f32'), (hbm, 'HBM'), (tc, 'tensor cores'))
    return dict(f32_ms=1e3 * f32, hbm_ms=1e3 * hbm, tc_ms=1e3 * tc,
                floor_ms=1e3 * floor, serial_ms=1e3 * (f32 + hbm + tc),
                binding=binding)


def analytic(kind, env, step_ms, peaks):
    """Prints the per-launch analytic table of the observe for one env: the
    plain version's work per test (:func:`observe_counts`, two divides in every
    test) over each set of rates. Its f32 floor at the measured rates
    describes that two-divide design; the kernel, which divides only where a
    cheap compare cannot decide, may run below it.

    Runs one observe at the env's reset state (seed 0), in the env's own mode,
    for the hit count the byte count needs.

    :param step_ms: a measured step time, or 0; with it the floor is also given
        as a share of the step.
    :param peaks: :func:`published_peaks`, optionally with ``measured``, a
        dict of the probes' rates under the same keys, and ``card``, the
        card's name and power limit.
    :return: the counts, and the unit times at each set of rates.
    """
    g = torch.Generator(device=env.device).manual_seed(0)
    state, _ = env.reset(g)
    args, kwargs = env.observe_args(state.agents)
    out = fused.observe(*args, **kwargs)
    dyn = kwargs.get('baked_dyn')
    counts = observe_counts(env.core.scenery, out, kwargs.get('skip_dyn', 0),
                            0 if dyn is None else dyn.shape[1],
                            kwargs.get('fast_div', False))
    N, A, R = out.indices.shape
    div_cost = peaks['div_cost']
    print(f'\n== {kind} @ {env.n_envs} envs ({N} scenes x {A} agents, res {R}), '
          f'one observe launch == [{peaks.get("card", "no card")}]')
    print(f'  ray-line tests    : {counts["ray_line_tests"]:,} over '
          f'{counts["live"]:,} live line slots')
    print(f'  f32 ops           : {counts["ops"]:,} + {counts["divides"]:,} '
          f'divides (x{div_cost} each)')
    print('  tensor-core flops : 0 (the port\'s kernels use none)')
    print(f'  bytes             : {counts["bytes"]:,} ({counts["hits"]:,} hit rays)')
    result = dict(counts=counts)
    for name, rates in (('published', peaks), ('measured', peaks.get('measured'))):
        if rates is None:
            continue
        t = _unit_times(counts, rates, div_cost)
        result[name] = t
        print(f'  per-unit @ {name:9s} : f32 {t["f32_ms"]:.4f} ms | tensor cores '
              f'{t["tc_ms"]:.4f} ms | HBM {t["hbm_ms"]:.4f} ms')
        print(f'  floor (max) {t["floor_ms"]:.4f} ms; no-overlap sum '
              f'{t["serial_ms"]:.4f} ms; binding unit: {t["binding"]}')
        if step_ms:
            print(f'  measured step {step_ms:.3f} ms -> floor is '
                  f'{100 * t["floor_ms"] / step_ms:.1f}% of the step')
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--measure', action='store_true',
                   help='also run the peak probes on the card (lower bounds on '
                        'attainable)')
    p.add_argument('--envs', type=int, default=16 * 1024,
                   help='envs (Explorer) and agent-envs (Deathmatch)')
    p.add_argument('--step-ms-explorer', type=float, default=None,
                   help='a measured Explorer step time, to give the floor as a '
                        'share of it')
    p.add_argument('--step-ms-deathmatch', type=float, default=None)
    p.add_argument('--device', choices=('cuda', 'cpu'), default=None,
                   help="where the envs run; 'cuda' unless given")
    args = p.parse_args(argv)
    device = scene.resolve_device(args.device or 'cuda')
    if args.measure and device.type != 'cuda':
        raise RuntimeError('--measure times the card: it needs a CUDA device')

    peaks = published_peaks()
    card = nvidia_smi() if device.type == 'cuda' else 'no card: counts only'
    peaks['card'] = card
    print(f'== peaks used (published, H100 SXM data sheet at 700 W) == [{card}]')
    print(f'  f32, no tensor cores : {peaks["f32_ops"] / 1e12:.1f} TFLOP/s '
          '(an FMA counts 2; the kernels issue none)')
    print(f'  bf16 tensor cores    : {peaks["tc_flops"] / 1e12:.0f} TFLOP/s')
    print(f'  device memory        : {peaks["hbm_bytes"] / 1e9:.0f} GB/s')
    print(f'  f32 divide           : {peaks["div_cost"]} f32 instructions')
    if args.measure:
        peaks['measured'] = dict(f32_ops=measure_vpu(), hbm_bytes=measure_hbm(),
                                 tc_flops=measure_mxu())
        m = peaks['measured']
        print(f'== measured probe rates (lower bounds on attainable) == [{card}]')
        print(f'  f32 multiplies (K2)  : {m["f32_ops"] / 1e12:.2f} T/s')
        print(f'  bf16 matmul chain    : {m["tc_flops"] / 1e12:.1f} TFLOP/s')
        print(f'  device memory stream : {m["hbm_bytes"] / 1e9:.0f} GB/s')

    for kind, step_ms in (('explorer', args.step_ms_explorer),
                          ('deathmatch', args.step_ms_deathmatch)):
        env = env_shapes(kind, args.envs, device)
        analytic(kind, env, step_ms or 0., peaks)
        del env


if __name__ == '__main__':
    main()
