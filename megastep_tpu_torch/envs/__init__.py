"""Demo environments built on the engine (counterpart of
:mod:`megastep_tpu.envs`).

Each env holds static config and device tables; ``reset(rng)`` and
``step(state, decision, rng)`` return ``(state, world)`` with ``world`` the
decision/world arrdict protocol: ``obs``, ``reward``, ``reset`` (Minimal's world
holds ``obs`` only, as in the JAX package).
"""
from .deathmatch import Deathmatch
from .explorer import Explorer
from .minimal import Minimal

__all__ = ['Deathmatch', 'Explorer', 'Minimal']
