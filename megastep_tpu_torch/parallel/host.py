"""Per-rank env construction.

Counterpart of :mod:`megastep_tpu.parallel.host`. Each rank builds only its own
slice of the envs (geometry, textures, bake) on its own device. The only global
work, which every rank repeats from the same global geometry list, is cheap
numpy: :func:`megastep_tpu_torch.scene.padded_sizes` (so that every rank pads
to the same shapes) and :func:`megastep_tpu_torch.scene.striped_order` over the
ranks (so that each rank's slice is size-sorted within itself, as the JAX
package's per-shard blocks are). The JAX module's ``assemble_env`` has no
counterpart: there is no global array to assemble (see
:mod:`megastep_tpu_torch.parallel.mesh`). Nor do its size buckets
(``obs_group_spec``): the port's observe kernel stops at each env's own line
count.
"""
import numpy as np

from .. import scene

__all__ = ['process_slice', 'sharded_explorer', 'sharded_deathmatch']


def process_slice(n_envs, m):
    """This rank's contiguous env range ``(lo, hi)`` of ``n_envs`` over mesh
    ``m``: an even split in rank order."""
    if n_envs % m.world:
        raise ValueError(f'{n_envs} envs do not split evenly over {m.world} ranks')
    n_local = n_envs // m.world
    lo = m.rank * n_local
    return lo, lo + n_local


def _local_geometries(geometries, n_agents, m):
    """The global striped scene order, and this rank's slice of the ordered
    geometry list."""
    order = scene.striped_order(geometries, n_agents, m.world)
    lo, hi = process_slice(len(geometries), m)
    return order, [geometries[i] for i in order[lo:hi]]


def sharded_explorer(n_envs, m, geometries, seed=0, **kwargs):
    """This rank's Explorer: its slice of the ``n_envs`` envs over mesh ``m``,
    built on ``m.device`` with ``RandomState(seed + rank)`` and padded to the
    global list's sizes. ``scene_order`` is the global order: env ``i`` of
    rank ``r`` uses ``geometries[scene_order[r * n_local + i]]``.

    :param geometries: the global list, one per env.
    :param kwargs: the env's own (``res``, ``subsample``, ...).
    """
    from ..envs import Explorer
    if len(geometries) != n_envs:
        raise ValueError(f'{len(geometries)} geometries for {n_envs} envs')
    pad = scene.padded_sizes(geometries, n_agents=1)
    order, local = _local_geometries(geometries, 1, m)
    env = Explorer(len(local), geometries=local, pad_to=pad,
                   random=np.random.RandomState(seed + m.rank), sort_scenes=False,
                   device=m.device, **kwargs)
    env.scene_order = order
    return env


def sharded_deathmatch(n_envs, m, geometries, n_agents=4, seed=0, **kwargs):
    """This rank's Deathmatch: its slice of the scenes over mesh ``m``, as
    :func:`sharded_explorer` builds an Explorer. ``n_envs`` counts agent-envs;
    ``geometries`` is the global scene list (``n_envs // n_agents`` long).
    """
    from ..envs import Deathmatch
    n_scenes = n_envs // n_agents
    if len(geometries) != n_scenes:
        raise ValueError(f'{len(geometries)} geometries for {n_scenes} scenes')
    pad = scene.padded_sizes(geometries, n_agents=n_agents)
    order, local = _local_geometries(geometries, n_agents, m)
    env = Deathmatch(len(local) * n_agents, n_agents=n_agents, geometries=local,
                     pad_to=pad, random=np.random.RandomState(seed + m.rank),
                     sort_scenes=False, device=m.device, **kwargs)
    env.scene_order = order
    return env
