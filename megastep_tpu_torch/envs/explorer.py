"""The Explorer environment: reward for seeing new texels.

Counterpart of :class:`megastep_tpu.envs.Explorer` (the reference
``megastep/demo/envs/explorer.py:8-130``). The seen-texel bookkeeping is a per-env
boolean tensor over the padded texel axis, and all state (seen set, potential,
episode lengths) lives in an explicit state arrdict.

The observe — raycast, shade and the seen-texel mask — is one call of
:func:`megastep_tpu_torch.ops.fused.observe`: on CUDA that is the
hand-written kernel, on the CPU its plain torch version.

One deliberate divergence from the reference, kept from the JAX package: the
reference writes ``seen[texindices] = True`` with miss-pixels carrying index -1,
which spuriously marks the *last* texel of the whole batch as seen. Here misses
are dropped.
"""
import numpy as np
import torch

from .. import core, cubicasa, modules, scene, tracing
from ..arrdict import arrdict, numpyify
from ..dotdict import dotdict
from ..ops import fused, render
from ..ops.geom import div


class Explorer:
    """Exploration env over multi-room floorplans: RGB + depth + IMU observations,
    momentum movement, reward per newly-seen texel.

    :param n_envs: number of environments.
    :param geometries: geometry list; ``None`` means
        :func:`cubicasa.sample(n_envs) <megastep_tpu_torch.cubicasa.sample>`,
        as in the JAX package: real floorplans from the dataset cache, or
        ``floorplans.sample(n_envs, seed=1)`` when the dataset is absent.
    :param subsample: rays pooled into one observed pixel.
    :param random: numpy ``RandomState`` for the textures, lights and spawn
        tables, consumed in the JAX package's order.
    :param pad_to: ``(Lmax, Kmax, Tmax)`` from :func:`scene.padded_sizes` over a
        larger geometry list, so that the per-rank builds of
        :mod:`megastep_tpu_torch.parallel.host` agree on shapes; the seen mask
        then spans the padded texel width.
    :param sort_scenes: order the scenes by texel count; ``False`` keeps the
        caller's order.
    :param device: where the env runs; ``'cuda'`` unless the caller says so.
    :param kwargs: ``res`` (default 256), ``fov`` (default 130) and the rest of
        :class:`~megastep_tpu_torch.core.Core`'s fields.

    Scenes are ordered by texel count (``scene.striped_order``) as the JAX
    package orders them; env ``i`` uses ``geometries[scene_order[i]]``.
    """

    def __init__(self, n_envs, geometries=None, subsample=4, random=None, pad_to=None,
                 sort_scenes=True, device='cuda', **kwargs):
        device = scene.resolve_device(device)
        if geometries is None:
            geometries = cubicasa.sample(n_envs)
        self.scene_order = (scene.striped_order(geometries, 1) if sort_scenes
                            else np.arange(len(geometries)))
        geometries = [geometries[i] for i in self.scene_order]
        scenery = scene.scenery(geometries, 1, random=random, pad_to=pad_to, device=device)
        self.core = core.Core(scenery, res=kwargs.pop('res', 4 * 64),
                              fov=kwargs.pop('fov', 130), **kwargs)
        self._rgb = modules.RGB(self.core, n_agents=1, subsample=subsample)
        self._depth = modules.Depth(self.core, n_agents=1, subsample=subsample)
        self._mover = modules.MomentumMovement(self.core)
        self._imu = modules.IMU(self.core)
        self._respawner = modules.RandomSpawns(geometries, self.core, random=random)

        # The texel table is static for a single-agent env (no dynamic re-bake),
        # so it is packed once here. The observe raycasts the static scenery
        # lines with the agent-model slots left out (skip_dyn): with one agent,
        # every model vertex sits strictly inside the camera near plane
        # (max |vertex| = width/2·√1.25 < radius = width/√2), so a drawn own-model
        # line could never pass the raycast's near < s test. skip_dyn must stay
        # on: the static head slots hold the unrotated model, not zeros.
        model_norm = float(scenery.model.norm(dim=-1).max())
        if not (scenery.n_agents == 1 and model_norm < self.core.agent_radius):
            raise ValueError('the static-lines observe needs one agent whose '
                             'model is inside its near plane')
        self._table = render.pack_table(scenery)

        self.action_space = self._mover.space
        self.obs_space = dotdict(
            rgb=self._rgb.space,
            d=self._depth.space,
            imu=self._imu.space)

    @property
    def n_envs(self):
        return self.core.n_envs

    @property
    def device(self):
        return self.core.device

    def observe_args(self, agents):
        """The step's :func:`fused.observe` call at ``agents``' poses, as
        ``(args, kwargs)``."""
        scn, c = self.core.scenery, self.core
        return ((scn.lines, scn.lines_width, scn.line_tex_starts,
                 scn.line_tex_widths, self._table, agents.angles, agents.positions,
                 c.res, c.half_screen_width, c.agent_radius),
                dict(skip_dyn=scn.n_dynamic))

    def _observe(self, agents, state_seen, reset):
        """Observe + seen-texel reward (reference ``explorer.py:34-58``).

        :return: ``(obs, seen, potential, reward)``.
        """
        c = self.core
        s = self._rgb.subsample
        args, kwargs = self.observe_args(agents)
        out = fused.observe(*args, **kwargs)
        rgb, d = modules.fused_obs(out, s, c.agent_radius, self._depth.max_depth)
        obs = arrdict(rgb=rgb, d=d, imu=self._imu(agents))

        seen = state_seen | out.seen
        potential = seen.sum(-1).float()
        old_potential = state_seen.sum(-1).float()
        reward = div(potential - old_potential, c.res // s)
        reward = torch.where(reset, 0., reward)
        return obs, seen, potential, reward

    def reset(self, rng):
        """Spawns everyone fresh. Returns ``(state, world)``.

        :param rng: a ``torch.Generator`` on the env's device, or the spawn-slot
            choices themselves, (n_envs, 1) int.
        """
        scn = self.core.scenery
        reset = self.core.env_full(True)
        agents = self._respawner(
            self.core.init_agents(), self.core.agent_full(True), rng)
        seen0 = torch.zeros(scn.baked.shape, dtype=torch.bool, device=self.device)
        obs, seen, potential, reward = self._observe(agents, seen0, reset)
        state = arrdict(
            agents=agents,
            progress=self.core.agent_full(1.),
            seen=seen,
            potential=potential,
            lengths=self.core.env_full(0))
        return state, arrdict(obs=obs, reward=reward, reset=reset)

    def step(self, state, decision, rng):
        """One step: move, maybe reset timed-out envs, observe, reward.
        Returns ``(state, world)`` (reference ``explorer.py:85-97``).

        :param decision: arrdict with ``actions`` (n_envs, 1) int in [0, 7).
        :param rng: a ``torch.Generator`` on the env's device, or the spawn-slot
            choices themselves, (n_envs, 1) int — used by the envs that reset.
        """
        with tracing.span('env.step'):
            agents, progress = self._mover(state.agents, decision)

            lengths = state.lengths + 1
            reset = lengths >= state.potential + 200

            # Respawn reset envs and clear their exploration bookkeeping.
            agents = self._respawner(agents, reset[:, None], rng)
            seen = torch.where(reset[:, None], False, state.seen)
            lengths = torch.where(reset, 0, lengths)

            obs, seen, potential, reward = self._observe(agents, seen, reset)
            state = arrdict(
                agents=agents, progress=progress, seen=seen,
                potential=potential, lengths=lengths)
            return state, arrdict(obs=obs, reward=reward, reset=reset)

    def state(self, state, world, e=0):
        """Numpy snapshot of env ``e`` for plotting, on the host
        (``megastep_tpu/envs/explorer.py:293-304``)."""
        T = int(self.core.scenery.tex_width[e])
        potential = numpyify(state.potential[e])
        return arrdict(
            core=self.core.state(state.agents, state.progress, e),
            rgb=numpyify(world.obs.rgb[e]),
            d=numpyify(world.obs.d[e]),
            potential=potential,
            seen=numpyify(state.seen[e, :T]),
            length=numpyify(state.lengths[e]),
            max_length=potential + 200)

    @classmethod
    def plot_state(cls, state):
        import matplotlib.pyplot as plt
        from .. import plotting
        fig = plt.figure()
        gs = plt.GridSpec(2, 2, fig, 0, 0, 1, 1)

        alpha = .1 + .9 * state.seen.astype(float)
        state = state.copy()
        state['core'] = state.core.copy()
        state.core['scenery'] = state.core.scenery.copy()
        state.core.scenery['textures'] = state.core.scenery.textures.copy()
        state.core.scenery.textures['vals'] = np.concatenate(
            [state.core.scenery.textures.vals, alpha[:, None]], 1)
        ax = core.Core.plot_state(state.core, plt.subplot(gs[:, 0]))

        images = {'rgb': state.rgb, 'd': state.d}
        plotting.plot_images(images, [plt.subplot(gs[:, 1])])

        s = (f'length: {int(state.length):d}/{state.max_length:.0f}\n'
             f'potential: {state.potential:.0f}')
        ax.annotate(s, (5., 5.), xycoords='axes points')
        return fig

    def display(self, state, world, e=0):
        return self.plot_state(self.state(state, world, e))
