"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU: it is marked ``cuda`` and skips without
one. The file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

Observe: indices and the seen mask must match exactly; distances and the
screen are held to allclose(rtol=1e-5, atol=1e-6). The in-kernel draw must equal
the launch on torch-drawn lines bit for bit. The f32 probe (K2) must equal its
plain version bit for bit: both are the same correctly rounded f32 multiplies.
"""
import numpy as np
import pytest
import torch

from megastep_tpu_torch import constants, floorplans, scene, toys
from megastep_tpu_torch.arrdict import arrdict
from megastep_tpu_torch.ops import fused, render
from megastep_tpu_torch.perf import roofline

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
HSW = float(np.tan(np.pi / 180 * 130 / 2))
RADIUS = constants.AGENT_RADIUS


@pytest.fixture(scope='module')
def scn():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    geoms = floorplans.sample(6, seed=3) + [toys.column()]
    return scene.scenery(geoms, 1, random=np.random.RandomState(0), device='cuda')


@pytest.fixture(scope='module')
def scn4():
    """Deathmatch's layout: four agents per env, their models head the lines."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    geoms = floorplans.sample(6, seed=3) + [toys.column()]
    return scene.scenery(geoms, 4, random=np.random.RandomState(0), device='cuda')


def _poses(n, a, seed):
    rng = np.random.RandomState(seed)
    angles = rng.uniform(-180, 180, (n, a)).astype(np.float32)
    positions = rng.uniform(2, 7, (n, a, 2)).astype(np.float32)
    return torch.from_numpy(angles).cuda(), torch.from_numpy(positions).cuda()


def _assert_match(got, want):
    assert set(got) == set(want)
    for k in {'indices', 'seen'} & set(got):
        np.testing.assert_array_equal(got[k].cpu().numpy(), want[k].cpu().numpy(),
                                      err_msg=k)
    for k in ('distances', 'screen'):
        np.testing.assert_allclose(got[k].cpu().numpy(), want[k].cpu().numpy(),
                                   **TOL, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize('res', [64, 256, 300])
def test_observe_kernel_matches_plain(scn, res):
    """Explorer mode (static lines, skip_dyn); res 300 is not a multiple of the
    block's 256 threads."""
    angles, positions = _poses(scn.n_envs, 1, res)
    args = (scn.lines, scn.lines_width, scn.line_tex_starts, scn.line_tex_widths,
            render.pack_table(scn), angles, positions, res, HSW, RADIUS)
    before = fused.observe.launches
    got = fused.observe(*args, skip_dyn=scn.n_dynamic)
    torch.cuda.synchronize()
    assert fused.observe.launches == before + 1
    want = fused.observe_plain(*args, skip_dyn=scn.n_dynamic)
    assert (want.indices < 0).any() and (want.indices >= 0).any()
    _assert_match(got, want)


@pytest.mark.cuda
def test_observe_kernel_two_agents_drawn_lines(scn):
    """Two agents per env over drawn lines, nothing skipped: agents see each
    other's models, and both write one env's seen mask."""
    angles, positions = _poses(scn.n_envs, 2, 1)
    two = scene.scenery(floorplans.sample(6, seed=3) + [toys.column()], 2,
                        random=np.random.RandomState(0), device='cuda')
    lines = render.draw(two, arrdict(angles=angles, positions=positions))
    args = (lines, two.lines_width, two.line_tex_starts, two.line_tex_widths,
            render.pack_table(two), angles, positions, 128, HSW, RADIUS)
    got = fused.observe(*args)
    want = fused.observe_plain(*args)
    assert (want.indices[want.indices >= 0] < two.n_dynamic).any()
    _assert_match(got, want)


def _deathmatch_args(scn4, res=128, seed=2):
    angles, positions = _poses(scn4.n_envs, 4, seed)
    dyn = torch.rand((scn4.n_envs, scn4.n_dynamic_texels), device='cuda',
                     generator=torch.Generator('cuda').manual_seed(seed)) + .25
    agents = arrdict(angles=angles, positions=positions)
    common = (scn4.lines_width, scn4.line_tex_starts, scn4.line_tex_widths,
              render.pack_table(scn4), angles, positions, res, HSW, RADIUS)
    return render.draw(scn4, agents), common, dyn


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['patch', 'draw_model', 'fast_div'])
def test_observe_kernel_deathmatch_modes_match_plain(scn4, mode):
    """The kernel's Deathmatch modes against the plain version: this frame's
    model-texel intensities (baked_dyn) on drawn lines, the in-kernel draw on
    the static lines, and the shared reciprocal; no seen mask."""
    drawn, common, dyn = _deathmatch_args(scn4)
    lines = scn4.lines if mode == 'draw_model' else drawn
    kwargs = dict(want_seen=False, baked_dyn=dyn,
                  draw_model=scn4.n_model_lines if mode == 'draw_model' else 0,
                  fast_div=mode == 'fast_div')
    got = fused.observe(lines, *common, **kwargs)
    want = fused.observe_plain(lines, *common, **kwargs)
    assert ((want.indices >= 0) & (want.indices < scn4.n_dynamic)).any()
    assert 'seen' not in got and 'seen' not in want
    _assert_match(got, want)


@pytest.mark.cuda
def test_observe_kernel_draw_model_equals_drawn_launch(scn4):
    """In-kernel draw on the static lines is the launch on torch-drawn lines,
    bit for bit, with and without the seen mask."""
    drawn, common, dyn = _deathmatch_args(scn4, res=512, seed=3)
    for want_seen in (False, True):
        a = fused.observe(drawn, *common, want_seen=want_seen, baked_dyn=dyn)
        b = fused.observe(scn4.lines, *common, want_seen=want_seen, baked_dyn=dyn,
                          draw_model=scn4.n_model_lines)
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
def test_observe_wrapper_checks_inputs(scn):
    angles, positions = _poses(scn.n_envs, 1, 0)
    table = render.pack_table(scn)
    base = dict(lines=scn.lines, lines_width=scn.lines_width,
                tex_starts=scn.line_tex_starts, tex_widths=scn.line_tex_widths,
                table=table, angles=angles, positions=positions, res=64,
                half_screen_width=HSW, agent_radius=RADIUS)
    dyn = torch.ones((scn.n_envs, scn.n_dynamic_texels), device='cuda')
    too_wide = torch.ones((scn.n_envs, table.shape[1] + 1), device='cuda')
    bad = [dict(angles=angles.double()), dict(table=table[:, ::2]),
           dict(positions=positions.cpu()), dict(lines_width=scn.lines_width[:-1]),
           dict(baked_dyn=dyn.double()), dict(baked_dyn=dyn[:-1]),
           dict(baked_dyn=dyn[:, None]), dict(baked_dyn=too_wide),
           dict(draw_model=scn.n_model_lines, skip_dyn=scn.n_dynamic),
           dict(draw_model=scn.lines.shape[1] + 1)]
    for change in bad:
        with pytest.raises((TypeError, ValueError)):
            fused.observe(**{**base, **change})


@pytest.mark.cuda
@pytest.mark.parametrize('chain', [2, 256])
def test_vpu_probe_matches_plain_bit_for_bit(chain):
    """Ragged sizes: 1,155 elements, then 400,013, whole and from its second
    element on, which is not 16-byte aligned and takes the scalar path."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    g = torch.Generator('cuda').manual_seed(chain)
    flat = torch.randn(4 * 100_003 + 1, generator=g, device='cuda')
    cases = (torch.randn((3, 5, 7, 11), generator=g, device='cuda'), flat, flat[1:])
    before = roofline.vpu_chain.launches
    for x in cases:
        got = roofline.vpu_chain(x, chain)
        want = roofline.vpu_chain_plain(x, chain)
        torch.cuda.synchronize()
        assert got.shape == x.shape
        assert torch.equal(got, want), float((got - want).abs().max())
    assert roofline.vpu_chain.launches == before + len(cases)
