"""The observe on the edges of its decisions: crafted lines and wide scenes.

The inputs come from :mod:`megastep_tpu_torch.perf.observe_edges`: crafted line
arrays over a real scenery's texel layout (the tolerance tie-break, segment
endpoints, the parallel test at 1e-3, the near plane, an agent on a line's
start point; each case as listed and reversed), and floorplans with more than
64 live line slots, past the kernel's candidate mask. Slots past
``lines_width`` stay zero, because the JAX kernel ignores ``lines_width``.

- On the CPU, the plain version (what ``observe`` runs on CPU tensors) is held
  against ``megastep_tpu.ops.fused.observe`` in interpret mode. JAX is imported
  inside those tests only, and they skip where the JAX package cannot be
  imported, so this file also runs on the card's machine, which has no JAX.
- On the card (marker ``cuda``), the kernel is held against the plain version
  in every mode.

Indices and the seen mask must be exact. Distances and the screen are held to
allclose(rtol=1e-5, atol=1e-6), the stated floor; on the card they must also
be equal bit for bit, since the kernel computes the plain version's f32
operations. The crafted cases must also pick the slot each case names on the
middle ray of agent 0.
"""
import numpy as np
import pytest
import torch

from megastep_tpu_torch import constants, interop, scene
from megastep_tpu_torch.ops import fused, render
from megastep_tpu_torch.perf import observe_edges as edges

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
HSW = float(np.tan(np.pi / 180 * 130 / 2))
RADIUS = constants.AGENT_RADIUS
WIDE_RES = 64


@pytest.fixture(scope='module')
def jax_package():
    """The JAX package's modules, where they import (not on the card's
    machine)."""
    for name in ('jax', 'flax'):
        pytest.importorskip(name, reason='the JAX package is not installed here')


def _twin(geoms, n_agents):
    """The JAX scenery of ``geoms`` and the port's copy of it."""
    from megastep_tpu import scene as jscene
    jscn = jscene.scenery(geoms, n_agents, random=np.random.RandomState(0))
    fields = {k: np.asarray(getattr(jscn, k)) for k in interop.SCENERY_FIELDS}
    return jscn, interop.scenery_from_numpy(fields, jscn.n_agents,
                                            jscn.n_dynamic_texels, device='cpu')


def _jax_observe(jscn, lines, angles, positions, res, **kwargs):
    import jax.numpy as jnp
    from megastep_tpu.ops import fused as jfused
    jlines = jnp.asarray(lines.numpy())
    return jfused.observe(
        jlines, jfused.line_attrs(jlines, jscn),
        jfused.split_table8(jfused.pack_table8(jscn)), jscn.lines_width,
        jnp.asarray(angles.numpy()), jnp.asarray(positions.numpy()), res, HSW,
        RADIUS, interpret=True, env_block=2, **kwargs)


def _assert_matches_jax(got, want, T):
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(got.distances.numpy(), np.asarray(want.distances), **TOL)
    np.testing.assert_allclose(got.screen.numpy(), np.asarray(want.screen), **TOL)
    np.testing.assert_array_equal(got.seen.numpy(),
                                  np.asarray(want.seen_counts)[:, :T] > 0)


@pytest.mark.parametrize('fast_div', [False, True])
def test_plain_matches_jax_on_crafted_edges(jax_package, fast_div):
    from megastep_tpu import floorplans as jfloorplans
    jscn, scn = _twin(jfloorplans.sample(2 * len(edges.cases(RADIUS)), seed=3), 1)
    lines, angles, positions, winners = edges.crafted(scn, RADIUS)
    want = _jax_observe(jscn, lines, angles, positions, edges.RES, want_seen=True,
                        skip_dyn=scn.n_dynamic, fast_div=fast_div)
    got = fused.observe(lines, scn.lines_width, scn.line_tex_starts,
                        scn.line_tex_widths, render.pack_table(scn), angles,
                        positions, edges.RES, HSW, RADIUS, skip_dyn=scn.n_dynamic,
                        fast_div=fast_div)
    _assert_matches_jax(got, want, scn.baked.shape[1])
    np.testing.assert_array_equal(got.indices[:, 0, edges.RES // 2].numpy(),
                                  winners.numpy())


def test_plain_matches_jax_past_the_candidate_mask(jax_package):
    from megastep_tpu import floorplans as jfloorplans
    geoms = [g for g in jfloorplans.sample(2, width=35., height=35., max_depth=9,
                                           stop=.02) if len(g.walls) > 64]
    jscn, scn = _twin(geoms, 1)
    assert (scn.lines_width - scn.n_dynamic > 64).all()
    angles, positions = edges.random_poses(scn.n_envs, 1, 0)
    want = _jax_observe(jscn, scn.lines, angles, positions, WIDE_RES,
                        want_seen=True, skip_dyn=scn.n_dynamic)
    got = fused.observe(scn.lines, scn.lines_width, scn.line_tex_starts,
                        scn.line_tex_widths, render.pack_table(scn), angles,
                        positions, WIDE_RES, HSW, RADIUS, skip_dyn=scn.n_dynamic)
    _assert_matches_jax(got, want, scn.baked.shape[1])
    assert (got.indices - scn.n_dynamic >= 64).any(), 'winners past the mask'


def test_crafted_edges_are_what_they_claim():
    """The crafted walls meet every ray at s = d, and the tolerance-edge case
    sits on fl(2 + tol) exactly."""
    scn = edges.crafted_scenery(1, 'cpu')
    lines, angles, positions, winners = edges.crafted(scn, RADIUS)
    x = render.intersections(lines[:, scn.n_dynamic:], scn.lines_width - scn.n_dynamic,
                             angles, positions, edges.RES, HSW, RADIUS)
    assert (x.rux == 1).all()
    s = x.s[4, 0, :, :3]                            # 's at the tolerance edge'
    edge = np.float32(2) + np.float32(1e-4)
    assert (s[:, 0] == edge).all() and (s[:, 2] == 2).all()
    assert (s[:, 1] == np.nextafter(edge, np.float32(0))).all()
    assert (winners >= scn.n_dynamic).all()


@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')


def _kernel_matches_plain(args, kwargs):
    before = fused.observe.launches
    got = fused.observe(*args, **kwargs)
    torch.cuda.synchronize()
    assert fused.observe.launches == before + 1
    want = fused.observe_plain(*args, **kwargs)
    assert set(got) == set(want)
    for k in {'indices', 'seen'} & set(got):
        np.testing.assert_array_equal(got[k].cpu().numpy(), want[k].cpu().numpy(),
                                      err_msg=k)
    for k in ('distances', 'screen'):
        np.testing.assert_allclose(got[k].cpu().numpy(), want[k].cpu().numpy(),
                                   **TOL, err_msg=k)
        assert torch.equal(got[k], want[k]), k
    return got


@pytest.mark.cuda
@pytest.mark.parametrize('mode', edges.MODES)
def test_kernel_matches_plain_on_crafted_edges(card, mode):
    scn = edges.crafted_scenery(1 if mode == 'explorer' else 4, 'cuda')
    lines, angles, positions, winners = edges.crafted(scn, RADIUS)
    args, kwargs, _ = edges.mode_args(scn, lines, angles, positions, edges.RES,
                                      HSW, RADIUS, mode)
    got = _kernel_matches_plain(args, kwargs)
    assert torch.equal(got.indices[:, 0, edges.RES // 2], winners)


@pytest.mark.cuda
@pytest.mark.parametrize('mode', edges.MODES)
def test_kernel_matches_plain_past_the_candidate_mask(card, mode):
    A = 1 if mode == 'explorer' else 4
    scn = scene.scenery(edges.wide_geometries(4), A, random=np.random.RandomState(0),
                        device='cuda')
    assert (scn.lines_width - scn.n_dynamic > 64).all()
    angles, positions = edges.random_poses(scn.n_envs, A, 0, device='cuda')
    args, kwargs, _ = edges.mode_args(scn, scn.lines, angles, positions, WIDE_RES,
                                      HSW, RADIUS, mode)
    got = _kernel_matches_plain(args, kwargs)
    assert (got.indices - kwargs.get('skip_dyn', 0) >= 64).any(), 'winners past the mask'
