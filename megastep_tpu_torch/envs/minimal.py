"""A minimal environment: box world, RGB observations, simple movement.

Counterpart of :class:`megastep_tpu.envs.Minimal` (the reference
``megastep/demo/envs/minimal.py:7-52``), the template to copy when building your
own environment. It observes through the un-fused render (draw, raycast, shade
as torch ops, :func:`megastep_tpu_torch.modules.render`), as the JAX Minimal
renders with XLA ops and not the fused observe kernel.
"""
from .. import core, modules, scene, toys
from ..arrdict import arrdict, numpyify
from ..dotdict import dotdict


class Minimal:
    """A box env with RGB observations and simple movement. A good foundation for
    building your own environments.

    The scenery's textures and lights are drawn from numpy's global random
    state, as the JAX package draws them (``scene.scenery(..., random=None)``).

    :param n_envs: number of environments, one agent each.
    :param device: where the env runs; ``'cuda'`` unless the caller says so.
    :var obs_space: the observation space presented to the network.
    :var action_space: the action space presented to the network.
    """

    def __init__(self, n_envs=1, device='cuda'):
        device = scene.resolve_device(device)
        geometries = n_envs * [toys.box()]
        scenery = scene.scenery(geometries, n_agents=1, device=device)
        self.core = core.Core(scenery)
        self.spawner = modules.RandomSpawns(geometries, self.core)
        self.rgb = modules.RGB(self.core)
        self.movement = modules.SimpleMovement(self.core)

        self.obs_space = self.rgb.space
        self.action_space = self.movement.space

    @property
    def n_envs(self):
        return self.core.n_envs

    @property
    def device(self):
        return self.core.device

    def reset(self, rng):
        """Spawns all agents. Returns ``(state, world)``.

        :param rng: a ``torch.Generator`` on the env's device, or the spawn-slot
            choices themselves, (n_envs, 1) int.
        """
        agents = self.spawner(
            self.core.init_agents(), self.core.agent_full(True), rng)
        state = arrdict(agents=agents, progress=self.core.agent_full(1.))
        return state, arrdict(obs=self.rgb(agents=agents))

    def step(self, state, decision, rng=None):
        """Moves agents by ``decision.actions`` (n_envs, 1) and re-observes.
        Returns ``(state, world)``. Nothing here is random: ``rng`` is taken for
        the envs' common signature."""
        agents, progress = self.movement(state.agents, decision)
        state = arrdict(agents=agents, progress=progress)
        return state, arrdict(obs=self.rgb(agents=agents))

    def state(self, state, world, e=0):
        """Numpy snapshot of env ``e`` for plotting, on the host."""
        return dotdict(
            core=self.core.state(state.agents, state.progress, e),
            rgb=numpyify(world.obs[e]))

    @classmethod
    def plot_state(cls, state):
        import matplotlib.pyplot as plt
        fig = plt.figure()
        gs = plt.GridSpec(1, 3, fig)
        plan = plt.subplot(gs[:, :2])
        core.Core.plot_state(state.core, plan)
        im = plt.subplot(gs[:, -1])
        modules.RGB.plot_state(state.rgb, [im])
        return fig

    def display(self, state, world, e=0):
        return self.plot_state(self.state(state, world, e))
