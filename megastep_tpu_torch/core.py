"""The Core: static simulation config + scenery, and the agent state they act on.

Counterpart of :mod:`megastep_tpu.core`: a frozen dataclass of (scenery,
render/physics config); agent state is a separate arrdict of tensors passed
through :meth:`Core.physics`. Conventions: angles in degrees, positions in meters,
``fps`` simulation steps per second, observations in linear RGB in [0, 1].
"""
import dataclasses

import numpy as np
import torch

from . import constants
from .arrdict import arrdict, numpyify
from .dotdict import dotdict
from .scene import Scenery
from .ops import physics as _physics, render as _render

AGENT_WIDTH = constants.AGENT_WIDTH
TEXTURE_RES = constants.TEXTURE_RES
AGENT_RADIUS = constants.AGENT_RADIUS
gamma_encode = constants.gamma_encode
gamma_decode = constants.gamma_decode


def init_agents(n_envs, n_agents, device='cuda', dtype=torch.float32):
    """Zero-initialized agent state: ``angles`` (N, A) deg, ``positions`` (N, A, 2) m,
    ``angvelocity`` (N, A) deg/s, ``velocity`` (N, A, 2) m/s."""
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return arrdict(
        angles=z(n_envs, n_agents),
        positions=z(n_envs, n_agents, 2),
        angvelocity=z(n_envs, n_agents),
        velocity=z(n_envs, n_agents, 2))


_DTYPES = {bool: torch.bool, int: torch.int32, float: torch.float32}


@dataclasses.dataclass(frozen=True)
class Core:
    """The core physics and rendering configuration. Runs on the scenery's device.

    :var scenery: the compiled :class:`~megastep_tpu_torch.scene.Scenery`.
    :var res: horizontal resolution of observations (pixels).
    :var fov: field of view, degrees (< 180).
    :var fps: simulation step rate.
    :var agent_radius: disc radius of each agent, meters.
    """
    scenery: Scenery
    res: int = 64
    fov: float = 130.
    fps: float = 10.
    agent_radius: float = AGENT_RADIUS

    def __post_init__(self):
        assert self.fov < 180, 'FOV should be less than 180°'

    @property
    def device(self):
        return self.scenery.device

    @property
    def n_envs(self):
        return self.scenery.n_envs

    @property
    def n_agents(self):
        return self.scenery.n_agents

    @property
    def half_screen_width(self):
        """tan(fov/2) — the screen extent at unit depth (``kernels.cu:22``)."""
        return float(np.tan(np.pi / 180 * self.fov / 2))

    def init_agents(self):
        return init_agents(self.n_envs, self.n_agents, self.device)

    def physics(self, agents):
        """Collision-resolved motion step. Returns ``(new_agents, progress)``;
        ``progress < 1`` marks a collision (see ``ops.physics``)."""
        return _physics.physics(self.scenery, agents, self.fps, self.agent_radius)

    def render(self, agents, **kwargs):
        """Raycast render pass, as torch ops. Returns an arrdict of
        ``indices/locations/dots/distances`` (N, A, R) and ``screen`` (N, A, R,
        3) (see :func:`megastep_tpu_torch.ops.render.render`)."""
        return _render.render(self.scenery, agents, self.res,
                              self.half_screen_width, self.agent_radius, **kwargs)

    def env_full(self, x):
        """An (n_envs,)-tensor full of ``x``."""
        return torch.full((self.n_envs,), x, dtype=_DTYPES[type(x)],
                          device=self.device)

    def agent_full(self, x):
        """An (n_envs, n_agents)-tensor full of ``x``."""
        return torch.full((self.n_envs, self.n_agents), x, dtype=_DTYPES[type(x)],
                          device=self.device)


    def state(self, agents, progress, e=0):
        """Numpy snapshot of env ``e`` for plotting, on the host
        (``megastep_tpu/core.py:99-110``)."""
        return dotdict(
            n_envs=self.n_envs, n_agents=self.n_agents, res=self.res, fov=self.fov,
            agent_radius=self.agent_radius, fps=self.fps,
            scenery=self.scenery.state(e),
            agents=arrdict(
                angles=numpyify(agents.angles[e]),
                positions=numpyify(agents.positions[e])),
            progress=numpyify(progress[e]))

    @classmethod
    def plot_state(cls, state, ax=None, zoom=False):
        import matplotlib.pyplot as plt
        from . import plotting
        ax = ax or plt.axes()
        plotting.plot_lines(ax, state, zoom=zoom)
        plotting.plot_lights(ax, state)
        plotting.adjust_view(ax, state, zoom=zoom)
        plotting.plot_fov(ax, state)
        ax.set_xticks([])
        ax.set_yticks([])
        return ax
