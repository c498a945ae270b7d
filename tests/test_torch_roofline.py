"""The port's roofline module against the JAX package's, on the CPU.

- The plain version of the f32 probe K2 (``vpu_chain_plain``) is held against
  the JAX package's Pallas probe (``perf/roofline.py::measure_vpu``'s kernel)
  in interpret mode, on the same numpy input: tolerance 0, since both are the
  same sequence of correctly rounded f32 multiplies and one add. The JAX side
  runs in a process of its own (see the ``jax_probe`` fixture).
- The observe kernel's counts reach the ray-line test totals of the two bench
  envs at their full shapes, and :func:`bound` equals a count made element by
  element from the plain observe's outputs.
- The command line prints both analytic tables on the CPU and refuses to
  measure without a card.

The CUDA probe itself runs only on a card: ``tests/test_torch_kernels.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from megastep_tpu_torch import constants, floorplans, scene, toys
from megastep_tpu_torch.arrdict import arrdict
from megastep_tpu_torch.ops import fused, render
from megastep_tpu_torch.perf import roofline

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
HSW = float(np.tan(np.pi / 180 * 130 / 2))


#: Builds the JAX probe's pallas_call as measure_vpu does, in interpret mode
#: (``_timed`` stubbed, so the timed scan never runs), and saves its output on
#: seeded numpy inputs for each chain length.
_JAX_PROBE = """
import sys
import numpy as np
import jax.numpy as jnp
from jax.experimental import pallas as pl
from perf import roofline

pallas_call, built = pl.pallas_call, []
def interpreted(*args, **kwargs):
    built.append(pallas_call(*args, **{**kwargs, 'interpret': True}))
    return built[-1]
pl.pallas_call = interpreted
roofline._timed = lambda fn, *args, steps: 1.
out = {}
for chain in CHAINS:
    roofline.measure_vpu(L=8, R=128, chain=chain, E=2, n=2, steps=1)
    x = np.random.RandomState(chain).standard_normal((2, 2, 8, 128)).astype(np.float32)
    out[f'x{chain}'] = x
    out[f'y{chain}'] = np.asarray(built.pop()(jnp.asarray(x)))
np.savez(sys.argv[1], **out)
"""
CHAINS = (2, 8, 256)


@pytest.fixture(scope='module')
def jax_probe(tmp_path_factory):
    """The JAX probe's outputs, from a process whose XLA CPU backend is limited
    to AVX. XLA's CPU compiler always allows fused multiply-adds, and with FMA
    available it contracts the probe's last multiply into its add, which moves
    about one element in 4,096 by an ulp at chain 256. Without FMA, each of the
    body's multiplies and its add rounds on its own, as the jaxpr says."""
    path = tmp_path_factory.mktemp('probe') / 'probe.npz'
    env = {**os.environ, 'PYTHONPATH': str(ROOT), 'JAX_PLATFORMS': 'cpu',
           'XLA_FLAGS': '--xla_cpu_max_isa=AVX'}
    out = subprocess.run(
        [sys.executable, '-c', _JAX_PROBE.replace('CHAINS', repr(CHAINS)), str(path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return dict(np.load(path))


@pytest.mark.parametrize('chain', CHAINS)
def test_vpu_chain_plain_matches_jax_kernel(jax_probe, chain):
    x, want = jax_probe[f'x{chain}'], jax_probe[f'y{chain}']
    got = roofline.vpu_chain_plain(torch.from_numpy(x), chain).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_vpu_chain_runs_plain_on_cpu_and_raises_elsewhere():
    x = torch.from_numpy(np.random.RandomState(0).standard_normal((3, 5, 7))
                         .astype(np.float32))
    before = roofline.vpu_chain.launches
    assert torch.equal(roofline.vpu_chain(x, 8), roofline.vpu_chain_plain(x, 8))
    assert roofline.vpu_chain.launches == before
    with pytest.raises(ValueError, match='meta'):
        roofline.vpu_chain(torch.empty(16, device='meta'), 8)
    for chain in (0, 3):
        with pytest.raises(ValueError, match='even'):
            roofline.vpu_chain(x, chain)


@pytest.mark.parametrize('kind, tests', [('deathmatch', 380_960_768),
                                         ('explorer', 56_262_656)])
def test_observe_counts_at_bench_shapes(kind, tests):
    """The bench envs' shapes (``chip_smoke.py``): Deathmatch 4,096 scenes of 4
    agents at res 512, Explorer 16,384 envs at res 256 with the 8 model slots
    skipped, on floorplans.sample(512) tiled. The test count needs only the
    line widths, so the scenery is not baked and every ray misses."""
    n, agents, res = (4096, 4, 512) if kind == 'deathmatch' else (16384, 1, 256)
    geoms = floorplans.sample(512)
    scn = scene.scenery([geoms[i % 512] for i in range(n)], agents,
                        random=np.random.RandomState(0), bake_fn=None, device='cpu')
    skip = scn.n_dynamic if kind == 'explorer' else 0
    out = arrdict(indices=torch.full((n, agents, res), -1, dtype=torch.int32))
    counts = roofline.observe_counts(scn, out, skip)
    assert counts['ray_line_tests'] == tests
    assert counts['ray_line_tests'] == agents * res * counts['live']
    assert counts['divides'] == 2 * tests and counts['ops'] == 16 * tests


def _observed(mode):
    """A small baked scene and one plain observe in ``mode``, with the
    arguments :func:`roofline.bound` takes."""
    A = 1 if mode == 'explorer' else 4
    scn = scene.scenery(floorplans.sample(3, seed=4) + [toys.column()], A,
                        random=np.random.RandomState(2), device='cpu')
    rng = np.random.RandomState(5)
    N = scn.n_envs
    angles = torch.from_numpy(rng.uniform(-180, 180, (N, A)).astype(np.float32))
    positions = torch.from_numpy(rng.uniform(2, 6, (N, A, 2)).astype(np.float32))
    common = (scn.lines_width, scn.line_tex_starts, scn.line_tex_widths,
              render.pack_table(scn), angles, positions, 64, HSW,
              constants.AGENT_RADIUS)
    if mode == 'explorer':
        out = fused.observe(scn.lines, *common, skip_dyn=scn.n_dynamic)
        return scn, out, dict(skip=scn.n_dynamic)
    lines = render.draw(scn, arrdict(angles=angles, positions=positions))
    dyn = torch.from_numpy(rng.uniform(.25, 1, (N, scn.n_dynamic_texels))
                           .astype(np.float32))
    out = fused.observe(lines, *common, want_seen=False, baked_dyn=dyn,
                        fast_div=mode == 'fast_div')
    return scn, out, dict(t_dyn=scn.n_dynamic_texels, fast_div=mode == 'fast_div')


@pytest.mark.parametrize('mode', ['explorer', 'deathmatch', 'fast_div'])
def test_bound_equals_brute_force_count(mode):
    """Every input read once and every output written once, counted element by
    element; 18 f32 ops per ray-line test (19 with fast_div), each divide one
    operation, at 3.35 TB/s and 67 TFLOP/s."""
    scn, out, kw = _observed(mode)
    ms, by, counts = roofline.bound(scn, out, **kw)

    skip, t_dyn = kw.get('skip', 0), kw.get('t_dyn', 0)
    width = scn.lines_width.numpy()
    indices = out.indices.numpy()
    N, A, R = indices.shape
    T = scn.baked.shape[1]
    seen = 'seen' in out
    tests = nbytes = hits = 0
    for n in range(N):
        for i in range(skip, width[n]):
            nbytes += 4 * 4 + 4 + 4          # x0, y0, x1, y1; texel start, width
            tests += A * R
        nbytes += 4 * t_dyn + (T if seen else 0)
        for a in range(A):
            nbytes += 3 * 4                  # angle, x, y
            for r in range(R):
                nbytes += 4 + 4 + 3 * 4      # index, distance, r, g, b
                if indices[n, a, r] >= 0:
                    hits += 1
                    nbytes += 2 * 16 + (1 if seen else 0)
    ops = tests * (19 if kw.get('fast_div') else 18)
    assert hits and hits < N * A * R
    assert (counts['ray_line_tests'], counts['hits'], counts['bytes']) == (tests, hits, nbytes)
    assert counts['ops'] + counts['divides'] == ops
    want = 1e3 * max(nbytes / 3.35e12, ops / 67e12)
    assert ms == pytest.approx(want, rel=1e-12)
    assert by == ('bytes' if nbytes / 3.35e12 >= ops / 67e12 else 'operations')


def test_vpu_bound_counts_one_instruction_per_multiply():
    """K2's 17.25 G multiplies and adds at the probe's shape, one f32
    instruction per lane per clock: half the published FMA-counting 67
    TFLOP/s, about 0.515 ms, above the 537 MB of bytes (0.160 ms)."""
    numel = 64 * 8 * 256 * 512
    ms, by = roofline.vpu_bound(numel, 256)
    assert by == 'operations'
    assert ms == pytest.approx(1e3 * 257 * numel / 33.5e12, rel=1e-12)
    assert ms == pytest.approx(0.515, abs=5e-4)


def test_analytic_unit_times():
    """The table's per-unit times: f32 ops with each divide weighted by
    div_cost, bytes, no tensor cores; floor is the max, the sum the
    no-overlap bound, at each set of rates."""
    env = roofline.env_shapes('deathmatch', 8, device='cpu')
    measured = dict(f32_ops=30e12, hbm_bytes=3e12, tc_flops=600e12)
    peaks = dict(roofline.published_peaks(), measured=measured)
    result = roofline.analytic('deathmatch', env, 2., peaks)
    c = result['counts']
    assert c['ray_line_tests'] > 0 and c['hits'] > 0
    for name, rates in (('published', peaks), ('measured', measured)):
        t = result[name]
        f32 = 1e3 * (c['ops'] + peaks['div_cost'] * c['divides']) / rates['f32_ops']
        hbm = 1e3 * c['bytes'] / rates['hbm_bytes']
        assert t['f32_ms'] == pytest.approx(f32) and t['hbm_ms'] == pytest.approx(hbm)
        assert t['tc_ms'] == 0.
        assert t['floor_ms'] == pytest.approx(max(f32, hbm))
        assert t['serial_ms'] == pytest.approx(f32 + hbm)
        assert t['binding'] == ('f32' if f32 > hbm else 'HBM')


def test_roofline_command_prints_both_tables_on_cpu():
    env = {**os.environ, 'PYTHONPATH': str(ROOT), 'OMP_NUM_THREADS': '1'}
    out = subprocess.run([sys.executable, '-m', 'megastep_tpu_torch.perf.roofline',
                          '--device', 'cpu', '--envs', '8'], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    for kind in ('explorer', 'deathmatch'):
        assert f'== {kind} @ 8 envs' in out.stdout
    assert out.stdout.count('per-unit @ published') == 2
    assert 'measured' not in out.stdout


def test_roofline_measure_needs_a_card():
    with pytest.raises(RuntimeError, match='needs a CUDA device'):
        roofline.main(['--measure', '--device', 'cpu', '--envs', '1'])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            roofline.main(['--measure', '--envs', '1'])
        with pytest.raises(RuntimeError, match='no CUDA device'):
            roofline.measure_vpu(L=8, R=128, E=1, n=1)
