"""Env-building modules: movement systems, observers, spawns and lifespans.

Counterpart of :mod:`megastep_tpu.modules`. A module object holds static
configuration (action tables, spawn tables, scales) as tensors on the core's
device, and its ``__call__`` returns new tensors rather than mutating its inputs.
Randomness is an explicit input: a ``torch.Generator`` or the draws themselves.

:class:`RGB` and :class:`Depth` observe through the un-fused render
(:func:`render`, torch ops; Minimal uses it), and the Explorer and Deathmatch
pool the fused observe's output in :func:`fused_obs` instead. Not ported: the
TPU-only one-hot variants (``pool_mean(dot=)``, ``RandomSpawns(onehot=)``) and
the plotting snapshots (``RGB.plot_state``, ``RandomLifespans.state``).
"""
import numpy as np
import torch

from . import spaces, geometry, tracing
from .arrdict import arrdict, numpyify, torchify
from .ops import geom
from .ops.geom import div

to_local_frame = geom.to_local_frame
to_global_frame = geom.to_global_frame

# noop, forward/backward, strafe left/right, turn left/right — the reference's
# seven-action basis (modules.py:45-46).
_VELOCITY_BASIS = np.array(
    [[0., 0.], [0., 1.], [0., -1.], [1., 0.], [-1., 0.], [0., 0.], [0., 0.]])
_ANGVELOCITY_BASIS = np.array([0., 0., 0., 0., 0., +1., -1.])


def _draws(rng, shape, low, high):
    """Integers in ``[low, high)`` for a ``shape`` batch: drawn from ``rng`` if
    it is a ``torch.Generator``, else ``rng`` itself, as given draws of that
    shape."""
    if isinstance(rng, torch.Generator):
        return torch.randint(low, high, shape, generator=rng, device=rng.device)
    if tuple(rng.shape) != tuple(shape):
        raise ValueError(f'draws have shape {tuple(rng.shape)}, expected {tuple(shape)}')
    return rng


class SimpleMovement:
    """A momentum-free movement system: seven discrete actions set the velocity
    directly (reference ``modules.py:24-66``).

    :var space: the action space to present to the controlling network.
    """

    def __init__(self, core, speed=10, ang_speed=180, n_agents=None):
        self.core = core
        self._actionset = torchify(arrdict(
            velocity=speed / core.fps * _VELOCITY_BASIS,
            angvelocity=ang_speed / core.fps * _ANGVELOCITY_BASIS), core.device)
        self.space = spaces.MultiDiscrete(n_agents or core.n_agents, 7)

    def __call__(self, agents, decision):
        """Sets agent (angular) velocity from ``decision.actions`` and steps the
        physics. Returns ``(new_agents, progress)``."""
        delta = self._actionset[decision.actions.long()]
        agents = type(agents)(
            angles=agents.angles,
            positions=agents.positions,
            angvelocity=delta.angvelocity,
            velocity=to_global_frame(agents.angles, delta.velocity))
        return self.core.physics(agents)


class MomentumMovement:
    """A movement system *with* momentum: actions apply acceleration on top of
    decayed velocity (reference ``modules.py:68-118``).

    :var space: the action space to present to the controlling network.
    :var decay: multiplicative velocity decay per timestep.
    """

    def __init__(self, core, accel=5, ang_accel=180, decay=.125, n_agents=None):
        self.core = core
        self._actionset = torchify(arrdict(
            velocity=accel / core.fps * _VELOCITY_BASIS,
            angvelocity=ang_accel / core.fps * _ANGVELOCITY_BASIS), core.device)
        self.decay = decay
        self.space = spaces.MultiDiscrete(n_agents or core.n_agents, 7)

    def __call__(self, agents, decision):
        """Composes decayed velocity with this step's acceleration and steps the
        physics. Returns ``(new_agents, progress)``."""
        delta = self._actionset[decision.actions.long()]
        agents = type(agents)(
            angles=agents.angles,
            positions=agents.positions,
            angvelocity=(1 - self.decay) * agents.angvelocity + delta.angvelocity,
            velocity=(1 - self.decay) * agents.velocity
                     + to_global_frame(agents.angles, delta.velocity))
        return self.core.physics(agents)


def render(core, agents, **kwargs):
    """Renders and reshapes for convolution stacks: adds the height-1 axis to
    every key, and permutes ``screen`` to (n_envs, n_agents, channels, 1, res),
    the layout conv modules expect (reference ``modules.py:126-136``)."""
    r = core.render(agents, **kwargs)
    r = arrdict({k: v[:, :, None] for k, v in r.items()})
    r['screen'] = r.screen.permute(0, 1, 4, 2, 3)
    return r


def downsample(screen, subsample):
    """Factors the final width dimension into (width/subsample, subsample); chase
    with a mean/min/max over the trailing axis (reference ``modules.py:138-145``)."""
    return screen.reshape(*screen.shape[:-1], screen.shape[-1] // subsample, subsample)


def depth_transform(distances, agent_radius, max_depth):
    """Depth in [0, 1]: 1 at the near plane, 0 at ``max_depth`` meters or beyond."""
    return 1 - torch.clamp(div(distances - agent_radius, max_depth), 0, 1)


def fused_obs(out, subsample, agent_radius, max_depth):
    """The (rgb, depth) observation pair from a fused observe result
    (:func:`megastep_tpu_torch.ops.fused.observe`), pooled by a
    reshape-mean over ``subsample`` rays — the counterpart of the JAX package's
    ``fused_obs``/``fused_obs_raw``.

    :return: rgb (N, A, 3, 1, R/s) and depth (N, A, 1, 1, R/s).
    """
    rgb = downsample(out.screen, subsample).mean(-1)[:, :, :, None, :]
    depth = depth_transform(out.distances, agent_radius, max_depth)
    d = downsample(depth, subsample).mean(-1)[:, :, None, None, :]
    return rgb, d


class Depth:
    """Depth observations in [0, 1]: 1 at the near plane, 0 at ``max_depth`` meters
    (reference ``modules.py:147-189``). The Explorer and Deathmatch compute the
    pooled depth in :func:`fused_obs` from this module's scales.

    :var space: the observation space to present to the controlling network.
    """

    def __init__(self, core, n_agents=None, subsample=1, max_depth=10):
        n_agents = n_agents or core.n_agents
        self.core = core
        self.space = spaces.MultiImage(n_agents, 1, 1, core.res // subsample)
        self.max_depth = max_depth
        self.subsample = subsample

    def __call__(self, r=None, agents=None):
        """Returns an (n_env, n_agent, 1, 1, res/subsample)-tensor of depths.
        Pass ``r`` (the output of :func:`render`) to reuse an existing render."""
        r = render(self.core, agents) if r is None else r
        depth = depth_transform(r.distances, self.core.agent_radius, self.max_depth)
        return downsample(depth, self.subsample).mean(-1)[:, :, :, None]


class RGB:
    """Linear-RGB observations in [0, 1] (reference ``modules.py:191-238``). The
    Explorer and Deathmatch compute the pooled RGB in :func:`fused_obs` from
    this module's subsample.

    :var space: the observation space to present to the controlling network.
    """

    def __init__(self, core, n_agents=None, subsample=1):
        n_agents = n_agents or core.n_agents
        self.core = core
        self.space = spaces.MultiImage(n_agents, 3, 1, core.res // subsample)
        self.subsample = subsample

    def __call__(self, r=None, agents=None):
        """Returns an (n_env, n_agent, 3, 1, res/subsample)-tensor. Pass ``r`` to
        reuse an existing render."""
        r = render(self.core, agents) if r is None else r
        return downsample(r.screen, self.subsample).mean(-1)

    @classmethod
    def plot_state(cls, state, axes=None):
        """Plots a numpy RGB observation with imshow."""
        import matplotlib.pyplot as plt
        from . import plotting
        n_agents = state.shape[0]
        axes = plt.subplots(n_agents, 1, squeeze=False) if axes is None else axes
        plotting.plot_images({'rgb': state}, axes)
        return axes


class IMU:
    """Inertial measurements: (angular velocity, medial velocity, lateral velocity)
    in the agent's local frame, scaled to ~[-1, 1] (reference ``modules.py:240-270``).

    :var space: the observation space to present to the controlling network.
    """

    def __init__(self, core, speed_scale=10., ang_scale=360., n_agents=None):
        self.core = core
        self.space = spaces.MultiVector(n_agents or core.n_agents, 3)
        self.speed_scale = speed_scale
        self.ang_scale = ang_scale

    def __call__(self, agents):
        return torch.cat([
            div(agents.angvelocity[..., None], self.ang_scale),
            div(to_local_frame(agents.angles, agents.velocity), self.speed_scale)], -1)


def random_empty_positions(geometries, n_agents, n_points, random=np.random):
    """Pre-samples ``n_points`` empty spawn points per (geometry, agent) from the
    occupancy masks, as an (n_geometries, n_agents, n_points, 2) float array
    (reference ``modules.py:272-293``). Host-side numpy, done once at env build;
    consumes ``random`` in the same order as the JAX package."""
    points = []
    for g in geometries:
        sample = np.stack((np.asarray(g.masks) > 0).nonzero(), -1)

        # There might be fewer open points than we're asking for.
        n_possible = min(len(sample) // n_agents, n_points)
        sample = sample[random.choice(np.arange(len(sample)), (n_possible, n_agents), replace=True)]

        # So repeat the sample until we've got enough.
        sample = np.concatenate([sample] * int(n_points / len(sample) + 1))[-n_points:]
        sample = random.permutation(sample)
        points.append(geometry.centers(sample, g.masks.shape, g.res).transpose(1, 0, 2))
    return np.stack(points)


class RandomSpawns:
    """Respawns masked agents at precomputed random empty locations with zeroed
    velocities (reference ``modules.py:295-326``).

    Spawn tables are precomputed on the host at construction and uploaded to the
    core's device; the per-step respawn is a gather at the chosen spawn slots.
    """

    def __init__(self, geometries, core, n_spawns=100, random=None):
        self.core = core
        random = np.random.RandomState(1) if random is None else random
        with tracing.span('spawns.tables'):
            positions = random_empty_positions(geometries, core.n_agents, n_spawns, random)
            angles = random.uniform(-180, +180, (len(geometries), core.n_agents, n_spawns))
            self._spawns = torchify(arrdict(positions=positions, angles=angles), core.device)

    @property
    def n_spawns(self):
        return self._spawns.angles.shape[-1]

    def choices(self, shape, rng):
        """Spawn slots for a ``shape`` batch: drawn from ``rng`` if it is a
        ``torch.Generator``, else ``rng`` itself, as given draws of that shape."""
        return _draws(rng, shape, 0, self.n_spawns)

    def __call__(self, agents, reset, rng):
        """Returns new agents with the ``reset``-masked agents respawned.

        :param reset: (n_env, n_agent) bool mask.
        :param rng: a ``torch.Generator`` on the core's device, or the spawn-slot
            choices themselves: (n_env, n_agent) int in ``[0, n_spawns)``.
        """
        choices = self.choices(reset.shape, rng).to(self.core.device).long()
        angles = torch.gather(self._spawns.angles, -1, choices[..., None])[..., 0]
        positions = torch.gather(
            self._spawns.positions, -2,
            choices[..., None, None].expand(*choices.shape, 1, 2))[..., 0, :]
        return type(agents)(
            angles=torch.where(reset, angles, agents.angles),
            positions=torch.where(reset[..., None], positions, agents.positions),
            angvelocity=torch.where(reset, 0., agents.angvelocity),
            velocity=torch.where(reset[..., None], 0., agents.velocity))


class RandomLifespans:
    """Randomized per-agent lifespans, for decorrelating otherwise-synchronous env
    batches (reference ``modules.py:328-381``).

    Lifespan counters live in an explicit state arrdict created by
    :meth:`init_state` and passed through ``__call__``. Lifespans are drawn from
    ``[min_lifespan, max_lifespan)``, as ``jax.random.randint`` draws them.
    """

    def __init__(self, core, max_lifespan, min_lifespan=None):
        self.core = core
        self.min_lifespan = max_lifespan // 2 if min_lifespan is None else min_lifespan
        self.max_lifespan = max_lifespan

    def _lifespans(self, rng):
        shape = (self.core.n_envs, self.core.n_agents)
        drawn = _draws(rng, shape, self.min_lifespan, self.max_lifespan)
        return drawn.to(self.core.device, torch.int32)

    def init_state(self, rng):
        """The state at the start: nothing lived yet, lifespans drawn from
        ``rng``, a ``torch.Generator`` or the (n_envs, n_agents) draws."""
        return arrdict(
            lifespans=torch.zeros((self.core.n_envs, self.core.n_agents),
                                  dtype=torch.int32, device=self.core.device),
            max_lifespans=self._lifespans(rng))

    def __call__(self, state, rng, reset=None):
        """Increments time-lived; agents past their lifespan (or in ``reset``) get
        a True in the returned mask and a re-rolled lifespan. The re-rolls are
        drawn on every call, for every agent, as in the JAX package.

        :return: ``(new_state, reset_mask)``.
        """
        lifespans = state.lifespans + 1
        reset = torch.zeros_like(lifespans, dtype=torch.bool) if reset is None else reset
        reset = (lifespans >= state.max_lifespans) | reset
        rerolled = self._lifespans(rng)
        new_state = arrdict(
            lifespans=torch.where(reset, 0, lifespans),
            max_lifespans=torch.where(reset, rerolled, state.max_lifespans))
        return new_state, reset

    def state(self, state, e):
        """Numpy snapshot of env ``e`` for plotting."""
        return arrdict(lifespan=numpyify(state.lifespans[e]),
                       max_lifespan=numpyify(state.max_lifespans[e]))
