"""The port's fused observe against the JAX package's, on the CPU.

The plain version (what ``observe`` runs on CPU tensors) is held against
``megastep_tpu.ops.fused.observe`` in interpret mode, in each of its modes: the
Explorer mode (``want_seen=True, skip_dyn=n_dynamic``) at one agent, and at two
agents the Deathmatch table patch (the port's ``baked_dyn``), the in-kernel draw
(``draw_model``) and ``fast_div``. Both get the same scenery (carried across
with ``interop.scenery_from_numpy``) and the same poses and intensities, made
with numpy. Indices and the seen mask must match exactly; distances and the
screen are held to allclose(rtol=1e-5, atol=1e-6).

The CUDA kernel itself runs only on a card, where JAX is not installed: its
tests are in ``tests/test_torch_kernels.py``, which imports no JAX, and
``chip_smoke.py`` holds it against the plain version at the Explorer bench's
shapes.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from megastep_tpu import floorplans as jfloorplans, scene as jscene, toys as jtoys
from megastep_tpu.arrdict import arrdict as jarrdict
from megastep_tpu.ops import fused as jfused, render as jrender
from megastep_tpu_torch import constants, interop
from megastep_tpu_torch.arrdict import arrdict
from megastep_tpu_torch.ops import fused, render

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
RES = 64
HSW = float(np.tan(np.pi / 180 * 130 / 2))
RADIUS = constants.AGENT_RADIUS


def _case(n_agents, seed):
    """A JAX scenery of floorplans plus an unwalled column room (so some rays
    miss), the port's copy of it, and numpy poses inside each room."""
    geoms = jfloorplans.sample(3, seed=5) + [jtoys.column()]
    jscn = jscene.scenery(geoms, n_agents, random=np.random.RandomState(6))
    fields = {k: np.asarray(getattr(jscn, k)) for k in interop.SCENERY_FIELDS}
    scn = interop.scenery_from_numpy(fields, jscn.n_agents, jscn.n_dynamic_texels,
                                     device='cpu')
    rng = np.random.RandomState(seed)
    N = len(geoms)
    angles = rng.uniform(-180, 180, (N, n_agents)).astype(np.float32)
    positions = rng.uniform(2, 6, (N, n_agents, 2)).astype(np.float32)
    return jscn, scn, angles, positions


@pytest.fixture(scope='module')
def case():
    return _case(1, 11)


@pytest.fixture(scope='module')
def case2():
    """Two agents per env, which see each other's models."""
    return _case(2, 12)


def _ours(scn, angles, positions, skip):
    return fused.observe(
        scn.lines, scn.lines_width, scn.line_tex_starts, scn.line_tex_widths,
        render.pack_table(scn), torch.from_numpy(angles),
        torch.from_numpy(positions), RES, HSW, RADIUS, skip_dyn=skip)


def test_plain_observe_matches_jax_kernel(case):
    jscn, scn, angles, positions = case
    want = jfused.observe(
        jscn.lines, jfused.line_attrs(jscn.lines, jscn),
        jfused.split_table8(jfused.pack_table8(jscn)), jscn.lines_width,
        jnp.asarray(angles), jnp.asarray(positions), RES, HSW, RADIUS,
        want_seen=True, skip_dyn=jscn.n_dynamic, interpret=True, env_block=2)
    got = _ours(scn, angles, positions, scn.n_dynamic)

    idx = np.asarray(want.indices)
    np.testing.assert_array_equal(got.indices.numpy(), idx)
    assert (idx < 0).any() and (idx >= 0).any(), 'want both hits and misses'
    np.testing.assert_allclose(got.distances.numpy(), np.asarray(want.distances), **TOL)
    np.testing.assert_allclose(got.screen.numpy(), np.asarray(want.screen), **TOL)
    T = scn.baked.shape[1]
    np.testing.assert_array_equal(got.seen.numpy(),
                                  np.asarray(want.seen_counts)[:, :T] > 0)


def test_skip_dyn_rebases_and_matches_drawn_lines(case):
    """With one agent its own model is inside the near plane, so leaving the
    dynamic slots out (skip_dyn, static lines) gives exactly what raycasting the
    drawn line array gives; reported indices stay in the full id space."""
    _, scn, angles, positions = case
    skipped = _ours(scn, angles, positions, scn.n_dynamic)
    hit = skipped.indices >= 0
    assert (skipped.indices[hit] >= scn.n_dynamic).all()

    agents = arrdict(angles=torch.from_numpy(angles),
                     positions=torch.from_numpy(positions))
    drawn = render.draw(scn, agents)
    full = fused.observe(
        drawn, scn.lines_width, scn.line_tex_starts, scn.line_tex_widths,
        render.pack_table(scn), agents.angles, agents.positions, RES, HSW, RADIUS)
    for k in ('indices', 'distances', 'screen', 'seen'):
        np.testing.assert_array_equal(skipped[k].numpy(), full[k].numpy(), err_msg=k)


def test_padded_line_slots_are_zero(case):
    """The kernel relies on padded line slots being all-zero segments (the scene
    compile zero-fills them): such a slot can never win a ray."""
    _, scn, angles, positions = case
    L = scn.lines.shape[1]
    pad = torch.arange(L)[None] >= scn.lines_width[:, None]
    assert pad.any() and (scn.lines[pad] == 0).all()
    # Ignoring the widths (every slot live) changes nothing.
    wide = scn.replace(lines_width=torch.full_like(scn.lines_width, L))
    a = _ours(scn, angles, positions, scn.n_dynamic)
    b = _ours(wide, angles, positions, scn.n_dynamic)
    for k in ('indices', 'distances', 'screen', 'seen'):
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)


@pytest.mark.parametrize('mode', ['table_patch', 'draw_model', 'fast_div'])
def test_plain_observe_modes_match_jax_kernel(case2, mode):
    """Deathmatch's modes at two agents: this frame's intensities of the model
    texels (JAX: a static pre-split table patched by ``pack_table8_patch`` rows;
    here ``baked_dyn``), the in-kernel draw from the static lines, and the
    shared reciprocal."""
    jscn, scn, angles, positions = case2
    N, T_dyn = scn.n_envs, scn.n_dynamic_texels
    dyn = np.random.RandomState(13).uniform(.25, 1.25, (N, T_dyn)).astype(np.float32)
    jagents = jarrdict(angles=jnp.asarray(angles), positions=jnp.asarray(positions))
    agents = arrdict(angles=torch.from_numpy(angles),
                     positions=torch.from_numpy(positions))
    table8 = jfused.split_table8(jfused.pack_table8(jscn))
    kwargs, ours = {}, {}
    if mode == 'draw_model':
        jlines, lines = jscn.lines, scn.lines
        kwargs['draw_model'] = ours['draw_model'] = scn.n_model_lines
    else:
        jlines, lines = jrender.draw(jscn, jagents), render.draw(scn, agents)
    if mode == 'table_patch':
        kwargs.update(table_patch=jfused.pack_table8_patch(jscn, jnp.asarray(dyn)),
                      patch_rows=jfused.dynamic_rows(T_dyn, scn.baked.shape[1]))
        ours['baked_dyn'] = torch.from_numpy(dyn)
    if mode == 'fast_div':
        kwargs['fast_div'] = ours['fast_div'] = True
    want_seen = mode != 'table_patch'
    want = jfused.observe(
        jlines, jfused.line_attrs(jlines, jscn), table8, jscn.lines_width,
        jagents.angles, jagents.positions, RES, HSW, RADIUS, want_seen=want_seen,
        env_block=2, interpret=True, **kwargs)
    got = fused.observe(
        lines, scn.lines_width, scn.line_tex_starts, scn.line_tex_widths,
        render.pack_table(scn), agents.angles, agents.positions, RES, HSW, RADIUS,
        want_seen=want_seen, **ours)

    idx = np.asarray(want.indices)
    np.testing.assert_array_equal(got.indices.numpy(), idx)
    assert ((idx >= 0) & (idx < scn.n_dynamic)).any(), 'agents should see models'
    np.testing.assert_allclose(got.distances.numpy(), np.asarray(want.distances), **TOL)
    np.testing.assert_allclose(got.screen.numpy(), np.asarray(want.screen), **TOL)
    assert ('seen' in got) == want_seen
    if want_seen:
        np.testing.assert_array_equal(
            got.seen.numpy(), np.asarray(want.seen_counts)[:, :scn.baked.shape[1]] > 0)


def test_draw_model_equals_drawn_lines(case2):
    """The plain in-kernel-draw mode on the static lines gives, bit for bit, what
    the drawn line array gives; the drawn model texels' intensities come from
    baked_dyn, and without want_seen there is no seen mask."""
    _, scn, angles, positions = case2
    agents = arrdict(angles=torch.from_numpy(angles),
                     positions=torch.from_numpy(positions))
    dyn = torch.rand((scn.n_envs, scn.n_dynamic_texels),
                     generator=torch.Generator().manual_seed(0))
    common = (scn.lines_width, scn.line_tex_starts, scn.line_tex_widths,
              render.pack_table(scn), agents.angles, agents.positions, RES, HSW,
              RADIUS)
    drawn = fused.observe(render.draw(scn, agents), *common, want_seen=False,
                          baked_dyn=dyn)
    inner = fused.observe(scn.lines, *common, want_seen=False, baked_dyn=dyn,
                          draw_model=scn.n_model_lines)
    assert set(drawn) == set(inner) == {'indices', 'distances', 'screen'}
    for k in drawn:
        np.testing.assert_array_equal(drawn[k].numpy(), inner[k].numpy(), err_msg=k)
    # The patched intensities reach the screen: other values, other pixels.
    other = fused.observe(render.draw(scn, agents), *common, want_seen=False)
    model = (drawn.indices >= 0) & (drawn.indices < scn.n_dynamic)
    assert not torch.equal(drawn.screen.transpose(2, 3)[model],
                           other.screen.transpose(2, 3)[model])


def test_skip_dyn_and_draw_model_exclude(case2):
    _, scn, angles, positions = case2
    with pytest.raises(ValueError, match='draw_model'):
        fused.observe(scn.lines, scn.lines_width, scn.line_tex_starts,
                      scn.line_tex_widths, render.pack_table(scn),
                      torch.from_numpy(angles), torch.from_numpy(positions), RES,
                      HSW, RADIUS, skip_dyn=scn.n_dynamic,
                      draw_model=scn.n_model_lines)
