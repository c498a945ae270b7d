"""The port's renderer (the torch ground truth) and its dynamic re-bake against
the JAX package's, on the CPU, on a toy box scene and a floorplan scene.

Both packages get the same scenery (built from the same RandomState) and the same
poses, made with numpy. Hit indices must match exactly; distances, locations,
dots, the shaded screen and the re-baked intensities (f32 sums over lights, in
possibly different orders) are held to allclose(rtol=1e-5, atol=1e-6).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from megastep_tpu import floorplans as jfloorplans, scene as jscene
from megastep_tpu import toys as jtoys
from megastep_tpu.arrdict import arrdict as jarrdict
from megastep_tpu.ops import bake as jbake, render as jrender
from megastep_tpu_torch import core, floorplans, scene, toys
from megastep_tpu_torch.arrdict import arrdict
from megastep_tpu_torch.ops import bake, render

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
RES = 48


def _build(kind, n_agents, seed=8):
    if kind == 'box':
        ours, theirs = [toys.box(), toys.column()], [jtoys.box(), jtoys.column()]
    else:
        ours, theirs = floorplans.sample(3, seed=seed), jfloorplans.sample(3, seed=seed)
    scn = scene.scenery(ours, n_agents, random=np.random.RandomState(4), device='cpu')
    jscn = jscene.scenery(theirs, n_agents, random=np.random.RandomState(4))
    rng = np.random.RandomState(len(kind) + n_agents)
    N = scn.n_envs
    poses = dict(angles=rng.uniform(-180, 180, (N, n_agents)).astype(np.float32),
                 positions=rng.uniform(2, 7, (N, n_agents, 2)).astype(np.float32))
    return scn, jscn, poses


def _close(got, want, err_msg=''):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=err_msg)


@pytest.mark.parametrize('kind,n_agents', [('box', 1), ('box', 2), ('floorplan', 2)])
def test_raycast_and_shade_match_jax(kind, n_agents):
    scn, jscn, poses = _build(kind, n_agents)
    c = core.Core(scn, res=RES)
    agents = arrdict(angles=torch.from_numpy(poses['angles']),
                     positions=torch.from_numpy(poses['positions']))
    jagents = jarrdict(angles=jnp.asarray(poses['angles']),
                       positions=jnp.asarray(poses['positions']))

    drawn = render.draw(scn, agents)
    jdrawn = np.array(jrender.draw(jscn, jagents))
    _close(drawn, jdrawn, 'draw')

    # Both raycasts read the same (JAX-drawn) line array.
    args = (scn.lines_width, agents.angles, agents.positions, RES,
            c.half_screen_width, c.agent_radius)
    rc = render.raycast(torch.from_numpy(jdrawn), *args)
    jrc = jax.jit(jrender.raycast, static_argnums=(4, 5, 6))(
        jnp.asarray(jdrawn), jscn.lines_width, jagents.angles, jagents.positions,
        RES, c.half_screen_width, c.agent_radius)
    np.testing.assert_array_equal(rc.indices.numpy(), np.asarray(jrc.indices))
    hit = np.asarray(jrc.indices) >= 0
    assert hit.any()
    for k in ('distances', 'locations', 'dots'):
        _close(rc[k], jrc[k], k)

    # Shade the same raycast result in both.
    jscreen = jax.jit(lambda s, r: jrender.shade(s, r, s.baked, method='gather'))(
        jscn, jrc)
    rc_np = arrdict({k: torch.tensor(np.asarray(v)) for k, v in jrc.items()})
    _close(render.shade(scn, rc_np, scn.baked), jscreen, 'screen')


def test_render_box_goldens():
    """The frozen render statistics of ``test_golden.py`` (box scenery, seed 7,
    pose (3.5, 3.5) at 30°) reproduce through the port's full render pass."""
    scn = scene.scenery([toys.box()], 1, random=np.random.RandomState(7), device='cpu')
    c = core.Core(scn, res=64, fov=130, fps=10)
    agents = c.init_agents()
    agents['positions'] = torch.full_like(agents.positions, 3.5)
    agents['angles'] = torch.full_like(agents.angles, 30.)
    r = render.render(scn, agents, c.res, c.half_screen_width, c.agent_radius)
    assert bool((r.indices >= 8).all())
    d, s = r.distances[0, 0].numpy(), r.screen[0, 0].numpy()
    np.testing.assert_allclose(d.mean(), 2.7179689, rtol=1e-5)
    np.testing.assert_allclose(d.min(), 2.5000422, rtol=1e-5)
    np.testing.assert_allclose(d.max(), 3.4305263, rtol=1e-5)
    np.testing.assert_allclose(s.sum(), 10.617100, rtol=1e-4)
    assert int(r.indices.sum()) == 620
    np.testing.assert_allclose(r.locations[0, 0].mean().item(), 0.4114983, rtol=1e-5)
    np.testing.assert_allclose(r.dots[0, 0].mean().item(), -0.1577556, rtol=1e-4)


def _agents(poses):
    return (arrdict({k: torch.from_numpy(v) for k, v in poses.items()}),
            jarrdict({k: jnp.asarray(v) for k, v in poses.items()}))


def test_draw_dynamic_matches_jax():
    scn, jscn, poses = _build('floorplan', 2)
    agents, jagents = _agents(poses)
    dyn = render.draw_dynamic(scn, agents)
    assert dyn.shape == (scn.n_envs, scn.n_dynamic, 2, 2)
    _close(dyn, jrender.draw_dynamic(jscn, jagents))
    np.testing.assert_array_equal(render.draw(scn, agents)[:, :scn.n_dynamic].numpy(),
                                  dyn.numpy())


@pytest.mark.parametrize('k_max', [None, 'true'])
def test_dynamic_rebake_matches_jax(k_max):
    """The per-frame re-bake of the model texels, from the drawn models and the
    static walls, with all padded light slots or only the live ones (these
    floorplans have at most 5 lights, padded to 8)."""
    scn, jscn, poses = _build('floorplan', 2, seed=2)
    agents, jagents = _agents(poses)
    k = int(scn.lights_width.max()) if k_max else None
    assert k is None or k < scn.lights.shape[1], 'want padded light slots'
    nd = scn.n_dynamic
    got = bake.dynamic_texel_intensity_parts(
        scn, render.draw_dynamic(scn, agents), scn.lines[:, nd:], k_max=k)
    want = jbake.dynamic_texel_intensity_parts(
        jscn, jrender.draw_dynamic(jscn, jagents), jscn.lines[:, nd:], k_max=k)
    assert got.shape == (scn.n_envs, scn.n_dynamic_texels)
    _close(got, want)
    # The whole-array form is the same function.
    np.testing.assert_array_equal(
        bake.dynamic_texel_intensity(scn, render.draw(scn, agents), k_max=k).numpy(),
        got.numpy())


def test_render_rebake_matches_jax():
    """render() at two agents re-bakes the model texels by default, as JAX's
    does; the re-bake changes the shading of the model pixels. The two agents
    face each other a meter apart."""
    scn, jscn, poses = _build('box', 2)
    poses['angles'][:] = (0., 180.)
    poses['positions'][:] = ((2., 2.5), (3., 2.5))
    agents, jagents = _agents(poses)
    c = core.Core(scn, res=RES)
    args = (RES, c.half_screen_width, c.agent_radius)
    r = render.render(scn, agents, *args)
    jr = jrender.render(jscn, jagents, *args, rebake_dynamic=True)
    np.testing.assert_array_equal(r.indices.numpy(), np.asarray(jr.indices))
    for k in ('distances', 'screen'):
        _close(r[k], jr[k], k)
    model = (r.indices >= 0) & (r.indices < scn.n_dynamic)
    assert model.any(), 'agents should see each other'
    static = render.render(scn, agents, *args, rebake_dynamic=False)
    assert not torch.equal(r.screen[model], static.screen[model])
