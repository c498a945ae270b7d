"""The Deathmatch environment: multi-agent combat with line-of-sight shooting.

Counterpart of :class:`megastep_tpu.envs.Deathmatch` (the reference
``megastep/demo/envs/deathmatch.py:21-170``): each scene hosts ``n_agents``
agents; an agent "shoots" whichever opponents' body models appear in the middle
two columns of its downsampled render; health and damage bookkeeping, an
out-of-bounds penalty, and respawn at death. The env exposes ``n_envs = n_scenes
* n_agents`` by reshaping every (scene, agent) pair into its own single-agent
sub-env (``expand``/``collapse``), a pure reshape of the padded tensors.

Each frame the agent models are drawn (:func:`render.draw_dynamic`), their texels
are re-lit against the static walls (:func:`megastep_tpu_torch.ops.fused.rebake`),
and one call of :func:`megastep_tpu_torch.ops.fused.observe` raycasts and shades
with those intensities: on CUDA each of the two is a hand-written kernel, on
the CPU its plain torch version (for the re-bake,
:func:`megastep_tpu_torch.ops.bake.dynamic_texel_intensity_parts`).
"""
import numpy as np
import torch

from .. import core, cubicasa, modules, scene, spaces, tracing
from ..arrdict import arrdict, numpyify, torchify
from ..dotdict import dotdict, mapping
from ..ops import fused, render

CLEARANCE = 1.


@mapping
def expand(x):
    """(B, A, ...) -> (B*A, 1, ...): each (scene, agent) pair becomes a sub-env."""
    B, A = x.shape[:2]
    return x.reshape(B * A, 1, *x.shape[2:])


def collapse(x, n_agents):
    """(B*A, 1, ...) -> (B, A, ...): back to the scene-major layout."""
    @mapping
    def _collapse(v):
        B = v.shape[0]
        return v.reshape(B // n_agents, n_agents, *v.shape[2:])
    return _collapse(x)


class Deathmatch:
    """Multi-agent combat (see module docstring).

    :param n_envs: total sub-env count; there are ``max(n_envs // n_agents, 1)``
        scenes (the JAX package's deliberate divergence 2 from the reference,
        ``PARITY.md``; the same at the default ``n_agents=4``).
    :param n_agents: agents per scene.
    :param geometries: geometry list, one per scene; ``None`` means
        :func:`cubicasa.sample(n_scenes) <megastep_tpu_torch.cubicasa.sample>`,
        as in the JAX package: real floorplans from the dataset cache, or
        ``floorplans.sample(n_scenes, seed=1)`` when the dataset is absent.
    :param subsample: rays pooled into one observed pixel.
    :param draw_fused: draw the agent models inside the observe kernel, from the
        static lines (``draw_model``), instead of writing the drawn models into
        a copy of the line array each step. Same results, bit for bit.
    :param fast_div: the observe kernel's shared-reciprocal mode (``fast_div``),
        about an ulp off the exact quotients. Off by default, as in the JAX
        package, where only its kernel benchmark turns it on.
    :param random: numpy ``RandomState`` for the textures, lights and spawn
        tables, consumed in the JAX package's order.
    :param pad_to: ``(Lmax, Kmax, Tmax)`` from :func:`scene.padded_sizes` over a
        larger geometry list, so that the per-rank builds of
        :mod:`megastep_tpu_torch.parallel.host` agree on shapes.
    :param sort_scenes: order the scenes by texel count; ``False`` keeps the
        caller's order.
    :param device: where the env runs; ``'cuda'`` unless the caller says so.
    :param kwargs: ``res`` (default 512), ``fov`` (default 70) and the rest of
        :class:`~megastep_tpu_torch.core.Core`'s fields.

    Scenes are ordered by texel count (``scene.striped_order``) as the JAX
    package orders them; scene ``i`` uses ``geometries[scene_order[i]]``.
    """

    def __init__(self, n_envs, n_agents=4, geometries=None, subsample=4,
                 draw_fused=False, fast_div=False, random=None, pad_to=None,
                 sort_scenes=True, device='cuda', **kwargs):
        device = scene.resolve_device(device)
        n_scenes = max(n_envs // n_agents, 1)
        if geometries is None:
            geometries = cubicasa.sample(n_scenes)
        self.scene_order = (scene.striped_order(geometries, n_agents) if sort_scenes
                            else np.arange(len(geometries)))
        geometries = [geometries[i] for i in self.scene_order]
        scenery = scene.scenery(geometries, n_agents, random=random, pad_to=pad_to,
                                device=device)
        self.core = core.Core(scenery, res=kwargs.pop('res', 4 * 128),
                              fov=kwargs.pop('fov', 70), **kwargs)
        self._rgb = modules.RGB(self.core, n_agents=1, subsample=subsample)
        self._depth = modules.Depth(self.core, n_agents=1, subsample=subsample)
        self._imu = modules.IMU(self.core, n_agents=1)
        self._movement = modules.MomentumMovement(self.core, n_agents=1)
        self._spawner = modules.RandomSpawns(geometries, self.core, random=random)

        self.action_space = self._movement.space
        self.obs_space = dotdict(
            rgb=self._rgb.space,
            d=self._depth.space,
            imu=self._imu.space,
            health=spaces.MultiVector(1, 1))

        self._bounds = torchify(np.stack(
            [np.array(g.masks.shape) * g.res for g in geometries]), device)
        # The true maximum light count: the per-frame re-bake leaves the padded
        # light slots past it out.
        self._k_lights = int(scenery.lights_width.max())
        # The static shade table, packed once: the re-bake's intensities of the
        # agent-model texels reach the kernel as its baked_dyn operand.
        self._table = render.pack_table(scenery)
        self.draw_fused = draw_fused
        self.fast_div = fast_div

    @property
    def n_envs(self):
        return self.core.n_envs * self.core.n_agents

    @property
    def device(self):
        return self.core.device

    def _respawn(self, agents, health, damage, reset, rng):
        agents = self._spawner(agents, reset, rng)
        health = torch.where(reset, 1., health)
        damage = torch.where(reset, 0., damage)
        return agents, health, damage

    def _shoot(self, agents, health, damage, opponents_mid):
        """Matches shooters to targets through the middle two columns of the
        opponent-id image, and applies damage, wounds and the out-of-bounds
        penalty (reference ``deathmatch.py:54-72``).

        :param opponents_mid: (N, A, 1, 2) opponent ids at the two middle
            columns of the downsampled render, -1 where no opponent shows.
        :return: ``(health, damage, matchings, hits)``.
        """
        A = self.core.n_agents
        ids = torch.arange(A, device=self.device)
        # matchings: (N, shooter, target)
        matchings = (opponents_mid[:, :, None] == ids[None, None, :, None, None])
        matchings = matchings.any(-1).any(-1)

        hits = matchings.sum(2).float()
        wounds = matchings.sum(1).float()

        damage = damage + .05 * hits

        pos = agents.positions
        outside = ((pos < -CLEARANCE).any(-1)
                   | (pos > (self._bounds[:, None] + CLEARANCE)).any(-1))

        # 5% damage per wound, 5% for being out of bounds, .1% per timestep.
        health = health - .05 * (wounds + outside) - .001
        return health, damage, matchings, hits.reshape(-1)

    def _opponents(self, line_idxs):
        """Opponent agent ids from middle-column line indices (-1 where the
        pixel shows no agent model; reference ``deathmatch.py:74-86``)."""
        obj_idxs = torch.div(line_idxs, self.core.scenery.n_model_lines,
                             rounding_mode='floor')
        mask = (0 <= line_idxs) & (obj_idxs < self.core.n_agents)
        return torch.where(mask, obj_idxs, -1)

    def observe_args(self, agents):
        """Draws the agent models and re-bakes their texels at ``agents``'
        poses: the step's :func:`fused.observe` call, as ``(args, kwargs)``."""
        scn = self.core.scenery
        c = self.core
        nd = scn.n_dynamic
        with tracing.span('env.rebake'):
            dyn_lines = render.draw_dynamic(scn, agents)
            dyn = fused.rebake(scn, dyn_lines, scn.lines[:, nd:], k_max=self._k_lights)
        if self.draw_fused:
            lines, draw_model = scn.lines, scn.n_model_lines
        else:
            lines, draw_model = torch.cat([dyn_lines, scn.lines[:, nd:]], 1), 0
        return ((lines, scn.lines_width, scn.line_tex_starts, scn.line_tex_widths,
                 self._table, agents.angles, agents.positions, c.res,
                 c.half_screen_width, c.agent_radius),
                dict(want_seen=False, baked_dyn=dyn, draw_model=draw_model,
                     fast_div=self.fast_div))

    def _observe(self, agents, health, damage):
        """Draw, re-bake the agent-model texels, observe in one kernel call,
        pool, and shoot (the JAX package's ``_observe_fused``)."""
        c = self.core
        args, kwargs = self.observe_args(agents)
        out = fused.observe(*args, **kwargs)
        s = self._rgb.subsample
        rgb, d = modules.fused_obs(out, s, c.agent_radius, self._depth.max_depth)
        # The two rays the shoot test reads: downsample(indices, s)[..., s//2]
        # at the middle two downsampled columns.
        r0 = s * (c.res // s // 2 - 1) + s // 2
        opponents = self._opponents(out.indices[..., r0:r0 + s + 1:s][:, :, None])
        health, damage, matchings, hits = self._shoot(agents, health, damage,
                                                      opponents)
        obs = arrdict(rgb=rgb, d=d, imu=self._imu(agents), health=health[..., None])
        return obs, health, damage, matchings, hits

    def reset(self, rng):
        """Spawns everyone fresh. Returns ``(state, world)`` with the world
        expanded to the sub-env (agent-as-env) layout.

        :param rng: a ``torch.Generator`` on the env's device, or the spawn-slot
            choices themselves, (n_scenes, n_agents) int.
        """
        reset = self.core.agent_full(True)
        agents, health, damage = self._respawn(
            self.core.init_agents(), self.core.agent_full(0.),
            self.core.agent_full(0.), reset, rng)
        obs, health, damage, matchings, reward = self._observe(agents, health, damage)
        state = arrdict(agents=agents, progress=self.core.agent_full(1.),
                        health=health, damage=damage, matchings=matchings)
        return state, arrdict(obs=expand(obs), reward=reward, reset=reset.reshape(-1))

    def step(self, state, decision, rng):
        """One step: respawn the dead, move, observe and shoot (reference
        ``deathmatch.py:47-52, 88-96``). Returns ``(state, world)``.

        :param decision: arrdict with ``actions`` (n_envs, 1) int in [0, 7), in
            the sub-env layout.
        :param rng: a ``torch.Generator`` on the env's device, or the spawn-slot
            choices themselves, (n_scenes, n_agents) int — used by the agents
            that respawn.
        """
        with tracing.span('env.step'):
            reset = state.health <= 0
            agents, health, damage = self._respawn(
                state.agents, state.health, state.damage, reset, rng)
            agents, progress = self._movement(
                agents, collapse(decision, self.core.n_agents))
            obs, health, damage, matchings, reward = self._observe(agents, health, damage)
            state = arrdict(agents=agents, progress=progress,
                            health=health, damage=damage, matchings=matchings)
            return state, arrdict(obs=expand(obs), reward=reward, reset=reset.reshape(-1))

    def state(self, state, world, e=0):
        """Numpy snapshot of scene ``e`` for plotting, on the host
        (``megastep_tpu/envs/deathmatch.py:357-369``)."""
        obs = collapse(world.obs, self.core.n_agents)
        return arrdict(
            core=self.core.state(state.agents, state.progress, e),
            rgb=numpyify(obs.rgb[e]),
            d=numpyify(obs.d[e]),
            health=numpyify(state.health[e]),
            damage=numpyify(state.damage[e]),
            matchings=numpyify(state.matchings[e]),
            bounds=numpyify(self._bounds[e]))

    @classmethod
    def plot_state(cls, state):
        """The plan with the agents' lines of fire and the out-of-bounds
        rectangle, each agent's view, and bars of health, damage inflicted
        and, where the state holds a ``decision``, value. The rectangle takes
        the reference's ``(rows, cols)`` bounds reversed, as the JAX env does."""
        import matplotlib.collections as mcollections
        import matplotlib.patches as mpatches
        import matplotlib.pyplot as plt
        from .. import plotting

        n_agents = len(state.health)
        show_value = 'decision' in state

        fig = plt.figure()
        gs = plt.GridSpec(n_agents, 4 if show_value else 3, fig)
        colors = [f'C{i}' for i in range(n_agents)]

        plan = core.Core.plot_state(state.core, plt.subplot(gs[:-1, :-1]))

        origin, dest = state.matchings.nonzero()
        if len(origin):
            lines = state.core.agents.positions[np.stack([origin, dest], 1)]
            linecolors = np.array(colors)[origin]
            plan.add_collection(mcollections.LineCollection(
                lines, color=linecolors, linewidth=1, alpha=.5))

        size = state.bounds[::-1] + 2 * CLEARANCE
        plan.add_artist(mpatches.Rectangle(
            (-CLEARANCE, -CLEARANCE), *size,
            linewidth=1, edgecolor='k', facecolor=(0., 0., 0., 0.)))

        images = {'rgb': state.rgb, 'd': state.d}
        plotting.plot_images(images, [plt.subplot(gs[i, -1]) for i in range(n_agents)])

        ax = plt.subplot(gs[-1, 0])
        ax.barh(np.arange(n_agents), state.health, color=colors)
        ax.set_ylabel('health')
        ax.set_yticks([])
        ax.invert_yaxis()
        ax.set_xlim(0, 1)

        ax = plt.subplot(gs[-1, 1])
        ax.barh(np.arange(n_agents), state.damage, color=colors)
        ax.set_ylabel('inflicted')
        ax.set_yticks([])
        ax.invert_yaxis()

        if show_value:
            ax = plt.subplot(gs[-1, 2])
            ax.barh(np.arange(n_agents), state.decision.value, color=colors)
            ax.set_ylabel('value')
            ax.set_yticks([])
            ax.invert_yaxis()
        return fig

    def display(self, state, world, e=0):
        return self.plot_state(self.state(state, world, e))
