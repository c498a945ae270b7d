"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU: it is marked ``cuda`` and skips without
one. The file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

Observe: indices and the seen mask must match exactly; distances and the
screen are held to allclose(rtol=1e-5, atol=1e-6). The in-kernel draw must equal
the launch on torch-drawn lines bit for bit. The f32 probe (K2) must equal its
plain version bit for bit: both are the same correctly rounded f32 multiplies.
The re-bake must take every occlusion decision of its plain version; its
intensities are held to allclose(rtol=1e-6, atol=1e-6), since it sums the
lights in another order.

The re-bake's wrapper on CPU tensors is its plain version; those tests need no
card and run everywhere.
"""
import numpy as np
import pytest
import torch

from megastep_tpu_torch import constants, envs, floorplans, scene, toys, tracing
from megastep_tpu_torch.arrdict import arrdict
from megastep_tpu_torch.ops import bake, fused, render
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


# --- The re-bake (fused.rebake) ---------------------------------------------

#: The re-bake sums the lights in light order; the plain version's sum may be
#: ordered otherwise, so an intensity may differ in its last bits.
REBAKE_TOL = dict(rtol=1e-6, atol=1e-6)


def _geoms():
    return floorplans.sample(6, seed=3) + [toys.column()]


@pytest.fixture(scope='module')
def scn4_cpu():
    return scene.scenery(_geoms(), 4, random=np.random.RandomState(0), device='cpu')


def _drawn(scn, seed):
    angles, positions = (torch.from_numpy(x).to(scn.lines.device)
                         for x in _np_poses(scn.n_envs, scn.n_agents, seed))
    return render.draw_dynamic(scn, arrdict(angles=angles, positions=positions))


def _np_poses(n, a, seed):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-180, 180, (n, a)).astype(np.float32),
            rng.uniform(2, 7, (n, a, 2)).astype(np.float32))


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('k_max', [None, 3])
def test_rebake_on_cpu_is_the_plain_version(scn4_cpu, seed, k_max):
    """On CPU tensors the wrapper returns the plain re-bake bit for bit, and
    launches and counts nothing."""
    scn = scn4_cpu
    dyn = _drawn(scn, seed)
    walls = scn.lines[:, scn.n_dynamic:]
    before = fused.rebake.launches
    tracing.enable()
    try:
        got = fused.rebake(scn, dyn, walls, k_max=k_max)
        counts = tracing.drain()['counts']
    finally:
        tracing.disable()
    want = bake.dynamic_texel_intensity_parts(scn, dyn, walls, k_max=k_max)
    assert got.dtype == torch.float32 and got.shape == (scn.n_envs, scn.n_dynamic_texels)
    assert torch.equal(got, want)
    assert fused.rebake.launches == before and counts == {}


def test_rebake_rejects_other_devices(scn4_cpu):
    scn = scn4_cpu
    dyn = _drawn(scn, 0).to('meta')
    with pytest.raises(ValueError, match='cuda or cpu'):
        fused.rebake(scn, dyn, scn.lines[:, scn.n_dynamic:])


def test_deathmatch_step_on_cpu_launches_no_rebake():
    """Deathmatch on the CPU re-bakes through the wrapper's plain path: the
    kernel's counter stays put, and the step's observations are those of the
    plain re-bake, bit for bit."""
    env = envs.Deathmatch(8, n_agents=4, geometries=[toys.box(), toys.box()], res=64,
                          subsample=1, random=np.random.RandomState(0), device='cpu')
    state, _ = env.reset(torch.zeros((2, 4), dtype=torch.int64))
    before = fused.rebake.launches
    args, kwargs = env.observe_args(state.agents)
    scn = env.core.scenery
    want = bake.dynamic_texel_intensity_parts(
        scn, render.draw_dynamic(scn, state.agents), scn.lines[:, scn.n_dynamic:],
        k_max=int(scn.lights_width.max()))
    assert torch.equal(kwargs['baked_dyn'], want)
    assert fused.rebake.launches == before


def _decisions(fn, scn, dyn, walls, k_max):
    """Every (texel, light) occlusion decision of ``fn`` (the kernel's wrapper
    or the plain re-bake), (N, P, K) bool: each light alone, at intensity .1,
    so that a lit texel reads at least 1e-4 above AMBIENT (the scenes are
    under 40 m across) and never reaches the clamp at 1."""
    K = scn.lights.shape[1] if k_max is None else min(k_max, scn.lights.shape[1])
    out = []
    for k in range(K):
        light = scn.lights[:, k:k + 1].clone()
        light[..., 2] = .1
        one = scn.replace(lights=light, lights_width=(scn.lights_width > k).int())
        out.append(fn(one, dyn, walls) > constants.AMBIENT + 1e-4)
    return torch.stack(out, -1)


def _assert_rebake_matches(scn, dyn, walls, k_max=None):
    """The kernel against the plain re-bake: every decision equal, the
    intensities within REBAKE_TOL. Returns the plain decisions."""
    before = fused.rebake.launches
    got = fused.rebake(scn, dyn, walls, k_max=k_max)
    torch.cuda.synchronize()
    assert fused.rebake.launches == before + 1
    want = bake.dynamic_texel_intensity_parts(scn, dyn, walls, k_max=k_max)
    decided = _decisions(fused.rebake, scn, dyn, walls, k_max)
    plain = _decisions(bake.dynamic_texel_intensity_parts, scn, dyn, walls, k_max)
    torch.cuda.synchronize()
    assert torch.equal(decided, plain), int((decided != plain).sum())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **REBAKE_TOL)
    return plain


@pytest.mark.cuda
@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('k_max', [None, 5])
def test_rebake_kernel_matches_plain(scn4, seed, k_max):
    """Random poses on the seven scenes, all their lights or the first five:
    some texels are shadowed, some lit, by every light."""
    dyn = _drawn(scn4, seed)
    lit = _assert_rebake_matches(scn4, dyn, scn4.lines[:, scn4.n_dynamic:], k_max)
    live = torch.arange(lit.shape[-1], device='cuda') < scn4.lights_width[:, None, None]
    assert (lit & live).any() and (~lit & live).any()


def _crafted(scn, case):
    """``scn`` with the walls and lights of one edge case, around each
    scene's first model texel C and a light I put 1.5 m from it (and 0.7 m
    across, but for the axis-aligned cases): the scenery, this frame's drawn
    models, the walls and ``k_max``."""
    dyn = _drawn(scn, 5)
    N, nd = scn.n_envs, scn.n_dynamic
    C = bake.texel_points(dyn, scn.tex_line, scn.line_tex_starts, scn.line_tex_widths,
                          0, 1, l_max=nd)[:, 0]                           # (N, 2)
    aligned = case in ('grazing_a_wall_end', 'wall_through_light')
    I = C + torch.tensor([1.5, 0. if aligned else .7], device='cuda')
    U = C - I                    # (-1.5, 0) to within rounding, where aligned
    perp = torch.stack([-U[:, 1], U[:, 0]], -1)
    up = torch.tensor([0., .4], device='cuda')
    walls = torch.zeros((N, scn.lines.shape[1] - nd, 2, 2), device='cuda')
    lights = scn.lights.clone()
    lights[:, 0, :2] = I
    lights_width = scn.lights_width.clamp(min=1)
    k_max = None

    def seg(*ends):
        return torch.stack(ends, 1)                                       # (N, 2, 2)
    mid = I + .5 * U
    # u x perp = |u|^2 at C: a slant of +-side*perp makes |u x v| = 2 side |u|^2.
    side = .25e-3 / (U * U).sum(-1, keepdim=True)
    if case == 'wall_through_light':
        # Through I across the ray (s = 0 at C exactly: pq = (0, -0.4)), and
        # at a slant through it.
        cut = [seg(I - up, I + up), seg(I - .1 * U, I + .5 * perp)]
    elif case == 'parallel_to_the_ray':
        # Along the ray, and across it at |u x v| = PARALLEL_EPS / 2 at C.
        cut = [seg(I + .2 * U, I + .8 * U),
               seg(I + .2 * U - side * perp, I + .8 * U + side * perp)]
    elif case == 'parallel_at_the_eps':
        # Across the ray at |u x v| = PARALLEL_EPS at C, to within rounding.
        cut = [seg(I + .2 * U - 2 * side * perp, I + .8 * U + 2 * side * perp)]
    elif case == 'grazing_a_wall_end':
        # Walls starting (t = 0) and ending (t = 1) on C's ray, exactly: C
        # and I share their y where aligned, and so does the wall's end.
        on_ray = torch.cat([mid[:, :1], I[:, 1:]], 1)
        cut = [seg(on_ray, on_ray + up), seg(on_ray - up, on_ray)]
    elif case == 'grazing_the_texel':
        # Across C's ray at s = .999, to within rounding, and just before
        # and past it.
        cut = [seg(I + f * U - perp, I + f * U + perp) for f in (.999, .9989, .9991)]
    elif case == 'padded_lights':
        # The light slots past lights_width hold lights that would shine.
        cut = [seg(mid - perp, mid + perp)]
        lights[:, 2:, 2] = 50.
        lights_width = torch.full_like(lights_width, 2)
    elif case == 'k_max_cut':
        # Every slot a live light; k_max leaves the bright ones out.
        cut = [seg(mid - perp, mid + perp)]
        lights[:, 2:, 2] = 50.
        lights_width = torch.full_like(lights_width, lights.shape[1])
        k_max = 2
    elif case == 'padded_wall_slots':
        # Slots past lines_width hold walls that would block everything.
        cut = [seg(mid - perp, mid + perp)]
        walls[:, 1:] = seg(mid - 9 * perp, mid + 9 * perp)[:, None]
    elif case == 'no_live_walls':
        cut = []
        walls[:] = seg(mid - 9 * perp, mid + 9 * perp)[:, None]
    else:
        raise ValueError(case)
    for i, w in enumerate(cut):
        walls[:, i] = w
    scn = scn.replace(lines_width=torch.full_like(scn.lines_width, nd + len(cut)),
                      lights=lights, lights_width=lights_width.int())
    return scn, dyn, walls, k_max


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['wall_through_light', 'parallel_to_the_ray',
                                  'parallel_at_the_eps', 'grazing_a_wall_end',
                                  'grazing_the_texel', 'padded_lights', 'k_max_cut', 'padded_wall_slots',
                                  'no_live_walls'])
def test_rebake_kernel_edge_cases(scn4, case):
    scn, dyn, walls, k_max = _crafted(scn4, case)
    lit = _assert_rebake_matches(scn, dyn, walls, k_max)
    if case in ('wall_through_light', 'parallel_to_the_ray', 'grazing_a_wall_end'):
        # Each of these walls misses C's ray from the light by its edge.
        assert lit[:, 0, 0].all()
    if case == 'no_live_walls':
        live = torch.arange(lit.shape[-1], device='cuda') < scn.lights_width[:, None, None]
        assert torch.equal(lit, live.expand_as(lit))


@pytest.mark.cuda
def test_rebake_kernel_widest_walls(scn4):
    """The most wall slots the wrapper takes at these lights and texels, all
    live (short random walls, some of which cross the rays); one more
    raises."""
    K, P = scn4.lights.shape[1], scn4.n_dynamic_texels
    W = 0
    while fused.rebake_smem_bytes(W + 1, K, P) <= fused.SMEM_BYTES:
        W += 1
    g = torch.Generator('cuda').manual_seed(0)
    a = torch.rand((scn4.n_envs, W, 1, 2), generator=g, device='cuda') * 9
    walls = torch.cat([a, a + torch.randn(a.shape, generator=g, device='cuda') * .3], 2)
    scn = scn4.replace(lines_width=torch.full_like(scn4.lines_width, scn4.n_dynamic + W))
    dyn = _drawn(scn, 6)
    _assert_rebake_matches(scn, dyn, walls)
    wider = torch.cat([walls, walls[:, :1]], 1)
    with pytest.raises(ValueError, match='shared memory'):
        fused.rebake(scn, dyn, wider)


@pytest.mark.cuda
def test_rebake_wrapper_checks_inputs(scn4):
    dyn = _drawn(scn4, 0)
    walls = scn4.lines[:, scn4.n_dynamic:]
    bad = [dict(dyn_lines=dyn.double()), dict(dyn_lines=dyn[:-1]),
           dict(dyn_lines=dyn.transpose(2, 3)),
           dict(walls=walls.double()), dict(walls=walls.cpu()), dict(walls=walls[:-1]),
           dict(walls=walls.transpose(2, 3)), dict(walls=walls[..., 0]),
           dict(k_max=-1), dict(scenery=scn4.replace(lights=scn4.lights.double())),
           dict(scenery=scn4.replace(lights_width=scn4.lights_width.long())),
           dict(scenery=scn4.replace(tex_line=scn4.tex_line[:, ::2])),
           dict(scenery=scn4.replace(lines_width=scn4.lines_width[:-1]))]
    base = dict(scenery=scn4, dyn_lines=dyn, walls=walls)
    for change in bad:
        with pytest.raises((TypeError, ValueError)):
            fused.rebake(**{**base, **change})


@pytest.mark.cuda
def test_deathmatch_step_rebakes_in_one_launch(monkeypatch):
    """Three Deathmatch steps on the card: each launches the re-bake once,
    counted by the wrapper and by the trace's counter inside ``env.rebake``,
    and its observations equal those of the same step with the plain
    re-bake within the step cell's limit, 1e-5 + 1e-5 * |plain|."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    env = envs.Deathmatch(28, n_agents=4, geometries=_geoms(), res=128,
                          random=np.random.RandomState(0), device='cuda')
    g = torch.Generator('cuda').manual_seed(0)
    state, _ = env.reset(torch.randint(0, 100, (7, 4), generator=g, device='cuda'))
    for _ in range(3):
        actions = arrdict(actions=torch.randint(0, 7, (28, 1), generator=g, device='cuda'))
        choices = torch.randint(0, 100, (7, 4), generator=g, device='cuda')
        before = fused.rebake.launches
        tracing.enable()
        try:
            got_state, got = env.step(state, actions, choices)
            rec = tracing.drain()
        finally:
            tracing.disable()
        assert fused.rebake.launches == before + 1
        assert rec['counts'].get('rebake_launches') == 1
        with monkeypatch.context() as m:
            m.setattr(fused, 'rebake', bake.dynamic_texel_intensity_parts)
            want_state, want = env.step(state, actions, choices)
        assert fused.rebake.launches == before + 1
        for k in ('rgb', 'd', 'imu', 'health'):
            a, b = got.obs[k], want.obs[k]
            assert ((a - b).abs() <= 1e-5 + 1e-5 * b.abs()).all(), k
        assert torch.equal(got.reset, want.reset)
        state = got_state
